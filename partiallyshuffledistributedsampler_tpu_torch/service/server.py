"""The index-serving daemon: one process owns epoch state, N clients stream.

A copy of the JAX package's ``service/server.py``: its frames, snapshots
and WAL records are byte-equal to the JAX package's, so a client of
either package streams from a server of either.  On a spec with
``backend="cuda"`` each regen is one launch of the spec's kernels on the
card and one readback; the backend stays outside the wire form.

``IndexServer`` owns exactly one :class:`~.spec.PartialShuffleSpec` and
serves its per-rank epoch streams over loopback TCP (the :mod:`.protocol`
framing).  Design points, in the order they matter:

* **One generation per (epoch, rank).**  A rank's stream is generated
  once via the spec's backend (cuda/cpu/native), cached read-only, and
  every (re)connected client of that rank replays from the cache — the
  redundant per-host regen the local samplers do N times collapses to
  one, and the regen latency is timed into ``epoch_regen_ms``.
* **Client-driven cursors → exactly-once.**  ``GET_BATCH`` names an
  explicit ``(epoch, seq)``; the server is a pure function of that name
  plus the spec, so a client that reconnects after a server restart and
  re-requests its cursor gets bit-identical bytes (counted as a
  ``resend`` when the seq was already served).
* **Backpressure.**  A rank may run at most ``max_inflight`` batches
  past its acked cursor; beyond that ``GET_BATCH`` draws an
  ``ERROR(code='throttle', retry_ms=...)`` instead of queueing unbounded
  frames into a slow consumer's socket.
* **Leases, not registrations.**  A rank is leased to one connection;
  the lease expires after ``heartbeat_timeout`` seconds of silence
  (evicted lazily on claim *and* by the accept-loop sweep, which also
  closes the idle socket).  A dropped connection releases its lease
  immediately, so crash-reconnect never waits out the timeout.
* **Snapshots.**  Server state — spec wire form, current epoch, per-rank
  cursors — persists through ``utils/checkpoint``'s atomic-json helpers
  to ``snapshot_path`` (on SET_EPOCH, lease changes, every
  ``snapshot_interval`` batches, and at ``stop()``); a restarted server
  resumes from it.  Correctness does not depend on the snapshot (streams
  are pure), it restores the *operational* state: the served epoch and
  where each client was.
* **Elastic membership** (docs/RESILIENCE.md "Elastic membership").  A
  client ``LEAVE`` (preemption-notice drain), a rank staying vacant past
  ``membership_timeout``, or an explicit ``RESHARD(new_world)`` RPC
  freezes a reshard barrier: the per-rank consumption watermarks already
  tracked by the batch cursors are converted to whole consumed base
  units (samples, or SHARDS for shard mode), the barrier is their max
  ``C``, and every live rank drains — keeps being served its old
  partition, clamped to the barrier's per-rank sample target.  A rank
  counts as drained only once the client has *acked* delivery of its
  full pre-barrier span (via ``GET_BATCH``'s ack, or a ``HEARTBEAT``
  carrying the cursor when the client is idle) — a served-but-lost
  final reply stays resendable instead of being dropped by the commit.
  When all participants have drained (dead ones become *orphan*
  descriptors, served later as a prefix of rank 0's stream), the server
  appends the
  ``(old_world, C)`` cascade layer from SPEC.md §6, re-partitions the
  remainder at the new world via ``ops.core``'s reshard chain, and bumps
  its ``generation``; requests stamped with a stale generation draw
  ``ERROR(code='resharded')`` carrying the new membership, so surviving
  clients pick up the remainder stream exactly-once — no index served
  twice or dropped.  The v2 snapshot persists the cascade + watermarks,
  so a killed-and-restarted daemon resumes mid-cascade.
* **Hot-standby replication** (docs/RESILIENCE.md "Replication &
  failover").  A primary constructed with ``standby=(host, port)``
  appends every state-mutating transition — lease grant/release, epoch
  set, ack-watermark advance, reshard freeze/drain/commit, snapshot
  seal — to a sequenced in-memory WAL (:mod:`.replication`) and ships
  it to an ``IndexServer(role='standby')`` over ``REPL_SYNC`` /
  ``REPL_APPEND`` frames; the standby bootstraps from the full
  snapshot-v2 state and continuously applies.  Clients learn the
  standby address at HELLO; on primary loss they re-HELLO the standby
  with ``failover=true``, which promotes it once its replication feed
  has been stale for ``repl_feed_timeout`` seconds (or immediately
  under a forced ``REPL_PROMOTE``).  Promotion bumps a monotonic
  fencing ``term``; a zombie ex-primary — still accepting after the
  promotion — learns the winning term through its own shipper and
  refuses every client write with ``ERROR(code='fenced')``, so
  split-brain cannot double-serve a span.
* **Multi-tenancy** (docs/SERVICE.md "Tenancy").  With
  ``multi_tenant=True`` the daemon serves many specs: namespaces are
  keyed by the world-stripped spec fingerprint, a HELLO carrying an
  unknown fingerprint plus its spec wire form creates-or-attaches a
  tenant (up to ``max_tenants``, through the ``tenant.admission`` fault
  site), and each tenant is an unstarted nested ``IndexServer`` engine
  owning its own leases/cursors/barriers/snapshot/metrics — the front
  server routes frames by the connection's HELLO binding (or an
  additive ``tenant`` header field), runs all tenants' epoch regens
  through one :class:`~..tenancy.FairShareScheduler`, enforces
  :class:`~..tenancy.TenantQuota` caps at admission with typed
  ``retry_ms`` backpressure, tags every WAL record with its tenant so
  one standby mirrors and fails over ALL tenants, and filters
  ``TRACE_DUMP`` so one tenant never reads another's spans.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
import warnings
import zlib
from collections import OrderedDict
from contextlib import nullcontext
from typing import Optional

import numpy as np

from .. import faults as F
from ..analysis.lockorder import new_lock
from .. import telemetry
from ..capability import EpochCapability
from ..durability import FsyncPolicy, WriteAheadLog
from ..durability.recover import replay_wal_tail
from ..telemetry import annotate as _annotate, span as _span
from ..tenancy import FairShareScheduler, TenantQuota, tenant_id_for
from ..utils.checkpoint import (
    list_tenant_snapshots,
    load_sampler_state,
    save_sampler_state,
    tenant_snapshot_path,
)
from . import protocol as P
from .backpressure import BackpressurePolicy
from .dispatch import DispatchListener
from .metrics import ServiceMetrics
from .replication import ReplicationLog, ReplicationShipper, TenantTaggedLog
from .spec import PartialShuffleSpec

SNAPSHOT_KIND = "index_service"

#: message types that mutate server state — the ones a fencing term
#: guards and a standby refuses pre-promotion (observability ops and the
#: REPL_* feed are exempt)
_MUTATING_MSGS = frozenset({
    P.MSG_HELLO, P.MSG_GET_BATCH, P.MSG_SET_EPOCH, P.MSG_HEARTBEAT,
    P.MSG_LEAVE, P.MSG_RESHARD, P.MSG_GET_CAPABILITY, P.MSG_APPEND,
})


def _state_crc(state: dict) -> int:
    """CRC32 over the canonical JSON of ``state`` minus its own crc
    field — what ``_write_snapshot`` embeds and ``_restore`` verifies,
    so a torn/corrupted snapshot is refused instead of half-applied."""
    body = json.dumps({k: v for k, v in state.items() if k != "crc32"},
                      sort_keys=True, separators=(",", ":")).encode()
    return zlib.crc32(body) & 0xFFFFFFFF


def _cursor_from_wire(c: dict) -> dict:
    """Rebuild one rank's batch cursor from a snapshot/WAL/replication
    record.  The streaming-only keys (``batch``, ``total`` — the advance
    barrier's pinned per-rank target, docs/STREAMING.md) must survive
    every restore path, or a recovered/promoted server would refuse the
    next horizon advance as a permanent straggler; frozen-dataset
    cursors carry neither and restore byte-identically."""
    cur = {"epoch": int(c["epoch"]), "acked": int(c["acked"]),
           "hi": int(c["hi"]), "samples": int(c.get("samples", 0))}
    for k in ("batch", "total"):
        if c.get(k) is not None:
            cur[k] = int(c[k])
    return cur


class IndexServer(DispatchListener):
    """Threaded loopback daemon serving one spec's index streams.

        spec = PartialShuffleSpec.plain(n, window=8192, world=4)
        with IndexServer(spec, port=0) as srv:   # ephemeral port
            addr = srv.address                   # (host, port)
            ...

    One thread accepts, one thread per connection serves; all daemonic.
    ``max_inflight`` bounds un-acked batches per rank; ``heartbeat_timeout``
    bounds how long a silent connection holds its rank lease.

    ``membership_timeout`` (seconds, default None = disabled) arms the
    eviction reshard: a rank whose lease stays vacant that long is
    treated as permanently preempted — the server triggers a reshard to
    ``world - vacancies`` and converts the rank's un-drained allocation
    to orphan descriptors instead of stalling the whole pod on it."""

    def __init__(
        self,
        spec: PartialShuffleSpec,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        max_inflight: int = 8,
        heartbeat_timeout: float = 30.0,
        membership_timeout: Optional[float] = None,
        snapshot_path: Optional[str] = None,
        snapshot_interval: int = 64,
        max_cached_arrays: Optional[int] = None,
        metrics: Optional[ServiceMetrics] = None,
        clock=time.monotonic,
        role: str = "primary",
        standby=None,
        repl_feed_timeout: float = 2.0,
        multi_tenant: bool = False,
        max_tenants: int = 8,
        tenant_quota: Optional[TenantQuota] = None,
        regen_scheduler: Optional[FairShareScheduler] = None,
        wal_dir: Optional[str] = None,
        fsync: str = "group_commit",
        capability_secret=None,
        backpressure: Optional[BackpressurePolicy] = None,
        cell_id: Optional[str] = None,
        cell_directory=None,
    ) -> None:
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        if role not in ("primary", "standby"):
            raise ValueError(f"role must be 'primary' or 'standby', "
                             f"got {role!r}")
        self.spec = spec
        self.host, self.port = host, int(port)
        self.max_inflight = int(max_inflight)
        #: every typed retry_ms hint comes from this table
        #: (service/backpressure.py) — tests pin sites, the autopilot's
        #: shed arm scales the whole table with observed queue depth
        self.backpressure = (backpressure if backpressure is not None
                             else BackpressurePolicy())
        # ---- multi-cell federation (docs/FEDERATION.md) ----
        #: which cell this server serves in; None on unfederated
        #: deployments (the cell gate and WELCOME fields then cost
        #: zero wire bytes)
        self.cell_id = None if cell_id is None else str(cell_id)
        #: the shared directory holder (``DirectoryRef``-like: its
        #: ``current()`` yields the live ``CellDirectory``) or a static
        #: directory value; consulted at every HELLO
        self._cell_directory = cell_directory
        #: the cell-cutover barrier (``freeze_writes``): while set,
        #: mutating client ops answer the retryable ``reshard`` refusal
        #: so a migration can ship a stable WAL tail
        self._cell_frozen = threading.Event()
        # ---- autopilot knobs (docs/AUTOPILOT.md) ----
        #: transport-batch size recommended to clients; None until a
        #: controller tunes it (zero WELCOME/heartbeat bytes until then)
        self._batch_hint: Optional[int] = None
        #: True once a controller touched a knob: heartbeat replies then
        #: carry the additive ``knobs`` field so already-connected
        #: clients adopt re-sized windows without a re-HELLO
        self._advertise_knobs = False
        #: newest replicated controller policy state (an ``autopilot``
        #: WAL record) — a promoted standby's controller resumes the
        #: closed loop from here  # guarded by: self._lock
        self._autopilot_state: Optional[dict] = None
        self.heartbeat_timeout = float(heartbeat_timeout)
        self.membership_timeout = (
            None if membership_timeout is None else float(membership_timeout)
        )
        self.snapshot_path = snapshot_path
        self.snapshot_interval = max(1, int(snapshot_interval))
        #: lease time source — injectable so eviction timing is testable
        #: against a fake clock (real deployments never override it)
        self._clock = clock
        # current epoch + one behind: a client finishing epoch e while
        # another already moved to e+1 must not thrash regeneration
        self._max_cached = (
            2 * spec.world if max_cached_arrays is None
            else max(1, int(max_cached_arrays))
        )
        self.metrics = metrics if metrics is not None else ServiceMetrics()
        self.epoch = 0
        self._lock = new_lock("server.state")  # leases / cursors / epoch
        self._gen_lock = new_lock("server.gencache")  # the (epoch, rank) cache
        self._cache: OrderedDict[tuple, object] = OrderedDict()  # guarded by: self._gen_lock
        #: rank -> {"owner": conn_id|None, "last_seen": t, "batch": int}
        self._leases: dict[int, dict] = {}  # guarded by: self._lock
        #: rank -> {"epoch": e, "acked": int, "hi": int, "samples": int}
        #: (hi = highest seq ever served, a request at or below it is a
        #: resend; samples = served sample high-water, the consumption
        #: watermark an elastic barrier cuts on)
        self._cursors: dict[int, dict] = {}  # guarded by: self._lock
        # ---- elastic membership state (all under self._lock) ----
        #: bumped at every reshard commit; GET_BATCH stamps it
        self.generation = 0  # guarded by: self._lock
        #: SPEC.md §6 cascade [(world, consumed_units), ...] outermost
        #: first, applying to epoch ``elastic_epoch`` only
        self.layers: list[tuple[int, int]] = []  # guarded by: self._lock
        self.elastic_epoch: Optional[int] = None  # guarded by: self._lock
        #: un-drained allocations of dead ranks, served as a prefix of
        #: rank 0's stream: JSON-safe {epoch, rank, world, layers, lo, hi}
        #: descriptors over the PURE partition stream of their generation
        self._orphans: list[dict] = []  # guarded by: self._lock
        #: in-flight reshard (phase 'freeze' → 'drain'), None otherwise
        self._reshard: Optional[dict] = None  # guarded by: self._lock
        #: per-deployment HMAC key for signed epoch capabilities
        #: (docs/CAPABILITY.md); None keeps GET_CAPABILITY refused and
        #: the wire format byte-identical to a pre-capability daemon
        self.capability_secret = capability_secret
        #: rank -> {"epoch", "gen", "total"} issued-capability records:
        #: which ranks consume via on-device regen (their ack-only
        #: cursors carry the consumption slack), replicated/persisted so
        #: a promoted standby keeps honoring the grants
        self._cap_records: dict[int, dict] = {}  # guarded by: self._lock
        #: rank -> clock time its lease went vacant (membership_timeout)
        self._vacated: dict[int, float] = {}  # guarded by: self._lock
        # ---- moving-horizon streaming (docs/STREAMING.md) ----
        #: True when the spec is a StreamSpec: ``self.epoch`` is the
        #: current horizon generation, and GET_BATCH/GET_CAPABILITY run
        #: the eligibility + ack-gated advance gate before serving
        self.streaming = getattr(spec, "mode", None) == "stream"
        #: True for a non-uniform sampling spec (docs/SAMPLING.md):
        #: SET_EPOCH accepts additive ``weights_delta`` re-weights
        #: (prioritized mode) and snapshots carry the adopted weights
        #: plus the dedup seen-state boundary
        self.sampling = getattr(spec, "sampling_mode", None) is not None
        #: absolute appended-sample total — monotonic, so a WAL replay
        #: takes the max and a dropped append record can only UNDER-count
        #: (the eligibility gate then serves later, never twice)
        self._stream_appended = 0  # guarded by: self._lock
        #: feeder id -> last applied stream_seq (APPEND retry dedup)
        self._stream_seqs: dict[str, int] = {}  # guarded by: self._lock
        #: accumulated additive per-source weights delta, folded into the
        #: spec's per-horizon weights at the next advance
        self._stream_pending: Optional[list] = None  # guarded by: self._lock
        #: horizon gen -> perf stamp of the append that opened it, popped
        #: into ``append_visible_ms`` when the horizon completes
        self._stream_first_t: dict[int, float] = {}  # guarded by: self._lock
        self._listener: Optional[socket.socket] = None
        self._threads: list[threading.Thread] = []
        self._conn_socks: dict[int, socket.socket] = {}
        self._next_conn_id = 0
        self._unsnapshotted = 0
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._snapshot_error_warned = False
        # ---- hot-standby replication (docs/RESILIENCE.md) ----
        #: 'primary' serves clients and (optionally) ships its WAL;
        #: 'standby' applies the feed and refuses data ops until promoted
        self.role = role
        #: monotonic fencing term; promotion bumps it, every REPL frame
        #: and post-failover client write carries it
        self.term = 0
        #: set when a newer term superseded this server: every client
        #: write is refused with ERROR(code='fenced') from then on
        self._fenced_term: Optional[int] = None
        self._standby_addr = (
            None if standby is None
            else (str(standby[0]), int(standby[1]))
        )
        self.repl_feed_timeout = float(repl_feed_timeout)
        self._repl_log: Optional[ReplicationLog] = None
        self._shipper: Optional[ReplicationShipper] = None
        # standby-side feed state
        self._applied_lsn = 0
        self._feed_last: Optional[float] = None
        self._primary_addr = None       # learned from REPL_SYNC
        self._seal_pending = False
        # ---- durability (docs/RESILIENCE.md "Durability & recovery") ----
        #: segment-WAL directory; None keeps the pre-durability behavior
        #: (in-memory replication log only, full-snapshot restores)
        self.wal_dir = wal_dir
        #: parsed eagerly so a bad policy string fails construction,
        #: not the first append
        self.fsync_policy = FsyncPolicy.parse(fsync)
        self._wal: Optional[WriteAheadLog] = None
        #: the WAL lsn the restored snapshot checkpoint reflects —
        #: recovery replays the tail strictly above it
        self._ckpt_lsn = 0  # guarded by: self._lock
        # ---- multi-tenancy (docs/SERVICE.md "Tenancy") ----
        #: this server's own namespace id — the world-stripped spec
        #: fingerprint hashed down to a short wire/file-safe token.  A
        #: single-tenant daemon still has one (it IS its default tenant).
        self.tenant_id = tenant_id_for(spec.fingerprint(include_world=False))
        self.multi_tenant = bool(multi_tenant)
        self.max_tenants = max(1, int(max_tenants))
        #: quota stamped onto tenants this daemon creates; the default
        #: tenant (the constructor spec) itself runs unquotaed unless a
        #: parent stamped one on this engine
        self.tenant_quota = (tenant_quota if tenant_quota is not None
                             else TenantQuota())
        self.quota: Optional[TenantQuota] = None
        #: tenant engines: unstarted IndexServer instances (no listener,
        #: no threads) owning one spec's leases/cursors/barriers/snapshot
        #: each; the front server routes frames into them
        self._tenants: "OrderedDict[str, IndexServer]" = OrderedDict()
        self._tenant_by_id: dict[str, "IndexServer"] = {}
        #: conn_id -> tenant engine bound at HELLO (front server only)
        self._conn_tenant: dict[int, "IndexServer"] = {}
        #: the engine's owner when this instance is a tenant engine
        self._parent: Optional["IndexServer"] = None
        #: shared fair-share regen queue (engines borrow the front's)
        self._regen_sched = (
            regen_scheduler if regen_scheduler is not None
            else (FairShareScheduler(metrics=self.metrics.registry)
                  if self.multi_tenant else None)
        )
        if (self._regen_sched is not None
                and self._regen_sched._metrics is None):
            # a caller-provided queue still reports wait time through
            # this daemon's registry (``regen_queue_ms``)
            self._regen_sched._metrics = self.metrics.registry

    # ------------------------------------------------------------ lifecycle
    def start(self) -> tuple[str, int]:
        """Bind, restore any snapshot, and begin accepting.  Returns the
        bound ``(host, port)`` — pass ``port=0`` for an ephemeral port."""
        if self._listener is not None:
            raise RuntimeError("server already started")
        self._stop.clear()
        self._draining.clear()
        self._recover_from_disk()
        # the accept loop (service/dispatch.py) doubles as the lease sweeper
        self._listener_bind()
        if self.role == "primary" and (self._standby_addr is not None
                                       or self._wal is not None):
            # the log exists whenever there is somewhere for records to
            # go: a standby to ship to, a WAL to write through to, or
            # both (then they share one lsn sequence)
            self._repl_log = ReplicationLog(metrics=self.metrics,
                                            wal=self._wal)
            for eng in self._engines():
                eng._repl_log = TenantTaggedLog(self._repl_log,
                                                eng.tenant_id)
            if self._standby_addr is not None:
                self._shipper = ReplicationShipper(
                    self._repl_log, self._standby_addr,
                    state_fn=self._repl_sync_state,
                    term_fn=lambda: self.term,
                    on_fenced=self._fence,
                    metrics=self.metrics,
                )
                self._shipper.start()
        return self.host, self.port

    @property
    def address(self) -> tuple[str, int]:
        return self.host, self.port

    def stop(self, drain_s: float = 0.05) -> None:
        """Graceful shutdown: drain, drop every connection, persist a
        snapshot.

        Drain phase: accepting stops and, for ``drain_s`` seconds,
        requests still arriving on live connections are answered
        ``ERROR(code='draining', retry_ms=...)`` — a structured "come
        back shortly" the retry layer sleeps on, instead of a raw reset
        racing the last reply.  Then every connection socket is shut down
        and closed *before* the serve threads are joined, so a thread
        blocked in ``recv`` wakes immediately and the join cannot leak
        threads; any survivor past the join timeout is counted
        (``leaked_threads``) and warned about rather than silently
        abandoned."""
        self._draining.set()
        shipper, self._shipper = self._shipper, None
        if shipper is not None:
            shipper.stop()
        ls, self._listener = self._listener, None
        if ls is not None:
            try:
                ls.close()
            except OSError:
                pass
        if drain_s > 0 and not self._stop.is_set():
            time.sleep(drain_s)
        self._stop.set()
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
                f"IndexServer.stop(): {len(leaked)} serve thread(s) "
                f"survived the join timeout: "
                f"{[t.name for t in leaked]}", RuntimeWarning,
            )
        self._threads.clear()
        for eng in self._engines():
            eng._draining.set()
            eng._stop.set()
            eng._write_snapshot(force=True)
        self._write_snapshot(force=True)
        wal, self._wal = self._wal, None
        if wal is not None:
            for eng in self._engines():
                eng._wal = None
            wal.close(sync=True)

    def kill(self) -> None:
        """Abrupt death for failover drills: the ``kill -9`` a ``stop()``
        is not.  No drain window, no final snapshot, no goodbye frames —
        the listener and every connection just disappear, exactly what
        clients of a preempted primary observe."""
        self._stop.set()
        shipper, self._shipper = self._shipper, None
        if shipper is not None:
            shipper.stop(join=False)
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
        # no final sync: a killed host never got one either.  The close
        # only drops the handle; whatever the fsync policy had already
        # made durable is what recovery will see
        wal, self._wal = self._wal, None
        if wal is not None:
            for eng in self._engines():
                eng._wal = None
            wal.close(sync=False)

    def __enter__(self) -> "IndexServer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------- tenancy
    def _engines(self) -> list:
        """The tenant engines (never includes self — the front server IS
        its own default tenant).  Safe without the lock: the dict only
        ever grows, and callers tolerate a stale snapshot of it."""
        return list(self._tenants.values())

    def tenants(self) -> dict:
        """Public view: ``tenant_id -> world-stripped fingerprint`` for
        every namespace this daemon serves, the default one included."""
        out = {self.tenant_id: self.spec.fingerprint(include_world=False)}
        with self._lock:
            for fp, eng in self._tenants.items():
                out[eng.tenant_id] = fp
        return out

    def _make_tenant_engine(self, spec: PartialShuffleSpec) -> "IndexServer":
        """Build (and, when its snapshot exists, restore) one tenant
        engine: an unstarted IndexServer owning the tenant's leases,
        cursors, barriers, snapshot file, and scoped metrics.  It shares
        the front server's socket plane, WAL, and fair-share queue."""
        q = self.tenant_quota
        tid = tenant_id_for(spec.fingerprint(include_world=False))
        eng = IndexServer(
            spec,
            max_inflight=q.clamp_inflight(self.max_inflight),
            heartbeat_timeout=self.heartbeat_timeout,
            membership_timeout=self.membership_timeout,
            snapshot_path=(tenant_snapshot_path(self.snapshot_path, tid)
                           if self.snapshot_path else None),
            snapshot_interval=self.snapshot_interval,
            metrics=self.metrics.scoped(tid),
            clock=self._clock,
            role=self.role,
            regen_scheduler=self._regen_sched,
            capability_secret=self.capability_secret,
            # shared object, not a copy: an autopilot shed-scale on the
            # front paces every tenant's refusals too
            backpressure=self.backpressure,
        )
        eng.quota = q
        eng._parent = self
        eng.term = self.term
        if self._repl_log is not None:
            eng._repl_log = TenantTaggedLog(self._repl_log, tid)
        if self._wal is not None:
            # the engine shares the front's WAL: its records are
            # tenant-tagged in the same lsn sequence, and registering it
            # as an owner pins GC until it has sealed twice itself
            eng._wal = self._wal
            self._wal.register_owner(tid)
        if self._regen_sched is not None:
            self._regen_sched.set_quota(tid, weight=q.weight,
                                        concurrency=q.regen_concurrency)
        if eng.snapshot_path and os.path.exists(eng.snapshot_path):
            try:
                eng._restore_from_disk()
            except (OSError, ValueError, KeyError) as exc:
                warnings.warn(
                    f"IndexServer: tenant snapshot {eng.snapshot_path!r} "
                    f"not restored ({exc!r}); tenant {tid} starts fresh",
                    RuntimeWarning,
                )
        return eng

    def _register_tenant_locked(self, fp: str, eng: "IndexServer") -> None:
        self._tenants[fp] = eng
        self._tenant_by_id[eng.tenant_id] = eng

    def _restore_tenants(self) -> None:
        """Rediscover per-tenant snapshots next to ``snapshot_path`` on
        start, so a restarted multi-tenant daemon resumes every
        namespace, not just its constructor spec's."""
        own = self.spec.fingerprint(include_world=False)
        for tid, path in list_tenant_snapshots(self.snapshot_path).items():
            try:
                st = load_sampler_state(path)
                spec = PartialShuffleSpec.from_wire(
                    st["spec"], backend=self.spec.backend)
            except (OSError, ValueError, KeyError) as exc:
                # with a WAL the previous checkpoint can still name the
                # tenant's spec; _make_tenant_engine then restores from
                # it through the same fallback path
                spec = None
                if self._wal is not None and os.path.exists(path + ".prev"):
                    try:
                        st = load_sampler_state(path + ".prev")
                        spec = PartialShuffleSpec.from_wire(
                            st["spec"], backend=self.spec.backend)
                    except (OSError, ValueError, KeyError):
                        spec = None
                if spec is None:
                    warnings.warn(
                        f"IndexServer: tenant snapshot {path!r} unreadable "
                        f"({exc!r}); skipped", RuntimeWarning)
                    continue
            fp = spec.fingerprint(include_world=False)
            if fp == own:
                continue
            eng = self._make_tenant_engine(spec)
            with self._lock:
                if fp not in self._tenants:
                    self._register_tenant_locked(fp, eng)

    def _apply_tenant_state_locked(self, tid: str, tstate: dict) -> None:
        """Standby side: route a replicated tenant state (REPL_SYNC's
        ``tenants`` map, or a ``tenant`` WAL record) into the mirror
        engine, creating it from the state's spec wire form first if
        this standby has never seen the tenant.  Under ``self._lock``;
        lock order is always front → engine."""
        eng = self._tenant_by_id.get(tid)
        if eng is None:
            wire = tstate.get("spec")
            if wire is None:
                return
            spec = PartialShuffleSpec.from_wire(wire,
                                                backend=self.spec.backend)
            fp = spec.fingerprint(include_world=False)
            eng = self._make_tenant_engine(spec)
            self._register_tenant_locked(fp, eng)
        with eng._lock:
            eng._apply_state_locked(tstate)

    def _regen_cost(self) -> float:
        """Fair-share cost of one epoch regen for this tenant — its
        per-rank sample count (heavier tenants advance their virtual
        time faster, so a 1B-sample regen yields the queue sooner)."""
        n = None
        try:
            n = self.spec.num_samples(0)
        except (TypeError, ValueError):
            n = None
        if n is None and self.spec.shard_sizes is not None:
            n = int(np.sum(self.spec.shard_sizes)) \
                // max(1, self.spec.world)
        return float(max(1, n if n is not None else 1))

    # ------------------------------------------------------------- snapshot
    def _state_dict(self) -> dict:
        """Snapshot format 2 (docs/SERVICE.md): v1's kind/proto/spec/
        epoch/cursors plus the elastic membership — generation, cascade
        layers, orphan descriptors, per-cursor sample watermarks, and an
        in-flight drain (so a killed daemon resumes mid-cascade).  Leave
        grace deadlines are monotonic-clock-relative and do NOT persist
        (a restarted drain falls back to ``membership_timeout``)."""
        with self._lock:
            return self._state_dict_locked()

    def _state_dict_locked(self) -> dict:
        state = {
            "kind": SNAPSHOT_KIND,
            "format": 2,
            "proto": P.PROTOCOL_VERSION,
            "spec": self.spec.to_wire(),
            "epoch": self.epoch,
            "generation": self.generation,
            "term": int(self.term),
            "layers": [[int(w), int(c)] for w, c in self.layers],
            "elastic_epoch": self.elastic_epoch,
            "orphans": [dict(o) for o in self._orphans],
            "cursors": {
                str(r): dict(c) for r, c in self._cursors.items()
            },
            # lease batch sizes: a standby needs them for the drain
            # gate ((acked+1)*batch >= target); ownership does not
            # replicate — every lease is vacant on the peer
            "leases": {str(r): int(l.get("batch") or 0)
                       for r, l in self._leases.items()},
            # issued-capability records (additive within format 2): a
            # restarted/promoted daemon keeps honoring outstanding
            # grants' ack-only cursors (docs/CAPABILITY.md)
            "capabilities": {str(r): dict(rec)
                             for r, rec in self._cap_records.items()},
        }
        if self.streaming:
            # additive within format 2 (docs/STREAMING.md): absent for
            # every frozen-dataset snapshot, which stays byte-identical.
            # Totals are absolute and seqs are maxima, so restoring an
            # older checkpoint plus the WAL tail converges on the truth.
            state["stream"] = {
                "appended": int(self._stream_appended),
                "seqs": {str(k): int(v)
                         for k, v in self._stream_seqs.items()},
                "pending": (list(self._stream_pending)
                            if self._stream_pending is not None else None),
                "weights": {str(g): [int(x) for x in w]
                            for g, w in self.spec.stream_weights.items()},
            }
        if self.sampling:
            # additive within format 2 (docs/SAMPLING.md): adopted
            # per-epoch weights (prioritized) and the newest dedup
            # epoch-boundary seen state.  Both are recomputable — the
            # weights from the WAL, the boundary by refolding from
            # epoch 0 — so the block is a recovery accelerator, never
            # the source of truth
            blk = {"weights": {str(g): [int(x) for x in w]
                               for g, w in self.spec.stream_weights.items()}}
            bw = None
            if hasattr(self.spec, "dedup_boundary_wire"):
                # epoch + 1: serving epoch e folds through its END, so
                # the newest boundary the spec holds is e+1's start —
                # exactly the state a successor needs for epoch e+1
                bw = self.spec.dedup_boundary_wire(self.epoch + 1)
            if bw is not None:
                blk["dedup"] = bw
            state["sampling"] = blk
        if self._wal is not None and self._repl_log is not None:
            # the WAL position this snapshot reflects — recovery
            # replays the tail strictly above it.  Exact: every append
            # happens under this same lock, so nothing can slip between
            # reading the lsn and sealing the state
            state["wal_lsn"] = int(self._repl_log.lsn)
        rs = self._reshard
        if rs is not None and rs.get("phase") == "drain":
            state["reshard"] = {
                "target_world": int(rs["target_world"]),
                "epoch": int(rs["epoch"]),
                "barrier_units": int(rs["barrier_units"]),
                "targets": {str(r): int(t)
                            for r, t in rs["targets"].items()},
                "drained": sorted(rs["drained"]),
                "dead": sorted(rs["dead"]),
                "leaving": sorted(rs["leaving"]),
            }
        return state

    def _recover_from_disk(self) -> dict:
        """The restart-time recovery sequence (docs/RESILIENCE.md
        "Durability & recovery"): open the WAL — a torn tail is
        detected and cut there — restore the newest readable snapshot
        checkpoint, rediscover tenant snapshots, then replay the WAL
        tail above each owner's watermark through the same record path
        a hot standby applies.  Runs before the socket binds;
        :func:`~..durability.recover_unstarted` drives it directly for
        the crash matrix.  Returns the replay stats dict."""
        # a standby with a wal_dir opens its OWN log too: the receive
        # side of cross-cell shipping persists applied records so a DR
        # cell can recover a tenant from its local tail alone
        # (docs/FEDERATION.md "Cross-cell shipping")
        if (self.wal_dir is not None
                and self.role in ("primary", "standby")
                and self._wal is None):
            self._wal = WriteAheadLog(self.wal_dir,
                                      fsync=self.fsync_policy,
                                      metrics=self.metrics)
            self._wal.register_owner(self.tenant_id)
            for eng in self._engines():
                # same-instance restart: engines re-attach to the
                # reopened log (their old handle was closed at stop)
                eng._wal = self._wal
                self._wal.register_owner(eng.tenant_id)
        self._restore_from_disk()
        if self.multi_tenant and self.snapshot_path:
            self._restore_tenants()
        if self._wal is None:
            return {"replayed": 0, "skipped": 0, "last_lsn": 0,
                    "replay_ms": 0.0}
        stats = replay_wal_tail(self)
        if self.role == "standby":
            # a restarted DR standby resumes its applied prefix from its
            # shipped-tail WAL; the feed's lsn-overlap check then makes
            # any re-shipped records idempotent
            with self._lock:
                self._applied_lsn = max(int(self._applied_lsn),
                                        int(self._wal.last_lsn))
        return stats

    def _restore_from_disk(self) -> None:
        """Restore from ``snapshot_path``.  Without a WAL this is the
        pre-durability behavior: the one snapshot either restores or —
        on a CRC failure — is refused loudly and the server starts
        fresh.  With a WAL, a corrupt or unreadable newest checkpoint
        falls back to its retained ``.prev`` predecessor plus a longer
        tail replay (counted as ``snapshot_fallbacks``); only when
        neither is readable does the state rebuild from lsn 0."""
        if not (self.snapshot_path and os.path.exists(self.snapshot_path)):
            return
        if self._wal is None:
            self._restore(load_sampler_state(self.snapshot_path))
            return
        for fallback, path in enumerate(
                (self.snapshot_path, self.snapshot_path + ".prev")):
            if not os.path.exists(path):
                continue
            try:
                state = load_sampler_state(path)
            except (OSError, ValueError) as exc:
                warnings.warn(
                    f"IndexServer: checkpoint {path!r} unreadable "
                    f"({exc!r}); trying the previous one", RuntimeWarning)
                continue
            if self._restore(state):
                if fallback:
                    self.metrics.inc("snapshot_fallbacks")
                    warnings.warn(
                        f"IndexServer: newest checkpoint was refused; "
                        f"fell back to {path!r} — the WAL replay covers "
                        "the difference", RuntimeWarning)
                return
        # neither checkpoint readable: the WAL replay rebuilds the
        # operational state from lsn 0

    def _restore(self, state: dict) -> bool:
        crc = state.get("crc32")
        if crc is not None and _state_crc(state) != int(crc):
            # a torn/corrupted snapshot must be refused, not half-loaded:
            # correctness never depends on it (streams are pure), so the
            # server starts fresh — loudly
            self.metrics.inc("snapshot_corrupt")
            warnings.warn(
                f"IndexServer: snapshot {self.snapshot_path!r} failed its "
                f"CRC32 check (stored {int(crc)}, computed "
                f"{_state_crc(state)}); refusing the corrupted snapshot "
                "and starting fresh", RuntimeWarning,
            )
            return False
        if state.get("kind") != SNAPSHOT_KIND:
            raise ValueError(
                f"snapshot kind {state.get('kind')!r} is not a "
                f"{SNAPSHOT_KIND!r} snapshot"
            )
        fmt = int(state.get("format", 1))
        theirs = PartialShuffleSpec.from_wire(state["spec"],
                                              backend=self.spec.backend)
        # world is authoritative SERVER state once resharding exists, so
        # the identity check strips it; a v2 snapshot's world is adopted
        ours = self.spec.fingerprint(include_world=False)
        if theirs.fingerprint(include_world=False) != ours:
            raise ValueError(
                "snapshot was written by a server with a different stream "
                f"spec: {theirs.fingerprint()} != {self.spec.fingerprint()}; "
                "serving it would hand clients a different permutation"
            )
        if fmt < 2 and theirs.world != self.spec.world:
            raise ValueError(
                f"pre-elastic (format 1) snapshot has world {theirs.world}; "
                f"this server was constructed with world {self.spec.world}"
            )
        with self._lock:
            self.epoch = int(state.get("epoch", 0))
            self._ckpt_lsn = int(state.get("wal_lsn", 0))
            self._cursors = {
                int(r): _cursor_from_wire(c)
                for r, c in state.get("cursors", {}).items()
            }
            if fmt < 2:
                return True
            self.generation = int(state.get("generation", 0))
            self.term = max(self.term, int(state.get("term", 0)))
            for r, b in (state.get("leases") or {}).items():
                l = self._leases.setdefault(
                    int(r), {"owner": None, "last_seen": self._clock(),
                             "batch": 0})
                l["batch"] = int(b)
            self.layers = [(int(w), int(c))
                           for w, c in state.get("layers") or []]
            ee = state.get("elastic_epoch")
            self.elastic_epoch = None if ee is None else int(ee)
            self._orphans = [dict(o) for o in state.get("orphans") or []]
            self._cap_records = {
                int(r): {"epoch": int(c["epoch"]), "gen": int(c["gen"]),
                         "total": int(c["total"])}
                for r, c in (state.get("capabilities") or {}).items()
            }
            if theirs.world != self.spec.world:
                self.spec = self.spec.with_world(theirs.world)
            st = state.get("stream")
            if self.streaming and st is not None:
                self._stream_appended = max(self._stream_appended,
                                            int(st.get("appended", 0)))
                for k, v in (st.get("seqs") or {}).items():
                    self._stream_seqs[str(k)] = max(
                        self._stream_seqs.get(str(k), -1), int(v))
                p = st.get("pending")
                self._stream_pending = (None if p is None
                                        else [int(x) for x in p])
                w = st.get("weights") or {}
                if w:
                    self.spec = self.spec.with_stream_weights(
                        {int(g): tuple(int(x) for x in ws)
                         for g, ws in w.items()})
            sm = state.get("sampling")
            if self.sampling and sm is not None:
                w = sm.get("weights") or {}
                if w:
                    self.spec = self.spec.with_stream_weights(
                        {int(g): tuple(int(x) for x in ws)
                         for g, ws in w.items()})
                bw = sm.get("dedup")
                if bw is not None and hasattr(self.spec,
                                              "with_dedup_boundary"):
                    # recovery accelerator only: folding from epoch 0
                    # reaches the identical state (docs/SAMPLING.md)
                    self.spec = self.spec.with_dedup_boundary(
                        int(bw["epoch"]), bw["seen"])
            rs = state.get("reshard")
            if rs is not None:
                self._reshard = {
                    "phase": "drain",
                    "target_world": int(rs["target_world"]),
                    "epoch": int(rs["epoch"]),
                    "barrier_units": int(rs["barrier_units"]),
                    "targets": {int(r): int(t)
                                for r, t in rs["targets"].items()},
                    "drained": {int(r) for r in rs.get("drained", [])},
                    "dead": {int(r) for r in rs.get("dead", [])},
                    "leaving": {int(r): None for r in rs.get("leaving", [])},
                }
                # every lease is vacant after a restart: put each
                # un-drained participant on the membership_timeout clock
                # now, so a participant that never reconnects (its grace
                # deadline did not survive the restart either) is
                # eventually declared dead instead of deadlocking the
                # barrier for every survivor
                now = self._clock()
                for r in self._reshard["targets"]:
                    if (r not in self._reshard["drained"]
                            and r not in self._reshard["dead"]):
                        self._vacated.setdefault(r, now)
        return True

    def _write_snapshot(self, force: bool = False) -> None:
        if not self.snapshot_path:
            return
        with self._lock:
            self._unsnapshotted += 1
            if not force and self._unsnapshotted < self.snapshot_interval:
                return
            self._unsnapshotted = 0
        state = self._state_dict()
        state["crc32"] = _state_crc(state)
        wal = self._wal
        try:
            F.fire("server.snapshot_write")
            if wal is not None and os.path.exists(self.snapshot_path):
                # previous-checkpoint retention: keep the predecessor so
                # a corrupt newest snapshot can fall back to it plus a
                # longer WAL replay (``snapshot_fallbacks``)
                os.replace(self.snapshot_path,
                           self.snapshot_path + ".prev")
            save_sampler_state(self.snapshot_path, state, durable=True)
            if self._repl_log is not None:
                # the seal marks the durable point in the WAL: a standby
                # with its own snapshot_path persists at the same cadence
                self._repl_log.append("seal", {})
            if wal is not None:
                # the seal is an incremental checkpoint: record this
                # owner's watermark and GC segments every owner has
                # checkpointed past (twice — previous retention)
                wal.sync()
                wal.checkpoint(self.tenant_id,
                               int(state.get("wal_lsn", 0)))
                with self._lock:
                    self._ckpt_lsn = int(state.get("wal_lsn", 0))
        except OSError as exc:
            # The snapshot is operational state, never a correctness
            # dependency (streams are pure functions of the spec) — a
            # full/unwritable disk must degrade observably, not take the
            # serving path down with it.
            self.metrics.inc("snapshot_errors")
            if not self._snapshot_error_warned:
                self._snapshot_error_warned = True
                warnings.warn(
                    f"IndexServer: snapshot write to "
                    f"{self.snapshot_path!r} failed ({exc!r}); serving "
                    "continues without persistence", RuntimeWarning,
                )

    # ------------------------------------------- hot-standby replication
    def _repl_append(self, op: str, **data) -> None:
        """Append one WAL record when replication is on (no-op
        otherwise).  Safe under ``self._lock`` — the log has its own
        lock and never takes the server's."""
        log = self._repl_log
        if log is not None:
            log.append(op, data)

    def _repl_sync_state(self) -> dict:
        state = self._state_dict()
        # the SYNC bootstrap also teaches the standby where the primary
        # serves, so its 'standby' refusals can redirect misrouted clients
        state["primary_addr"] = [self.host, self.port]
        tenants = {eng.tenant_id: eng._state_dict()
                   for eng in self._engines()}
        if tenants:
            state["tenants"] = tenants
        return state

    def _fence(self, term: int) -> None:
        """A newer term exists (the standby promoted past this server):
        refuse every client write from here on — split-brain must not
        double-serve a span.  Observability ops keep being served."""
        with self._lock:
            if self._fenced_term is None or int(term) > self._fenced_term:
                self._fenced_term = int(term)
        self.metrics.inc("fenced")
        telemetry.event("fenced", term=int(term))

    def _try_promote(self, force: bool = False) -> bool:
        """Standby → primary, gated on feed staleness: while the
        replication feed is fresh the primary is alive and the promotion
        is refused (split-brain guard); ``force`` overrides for an
        operator-driven switchover."""
        with self._lock:
            if self.role != "standby":
                return True
            if not force:
                last = self._feed_last
                if last is not None and \
                        self._clock() - last <= self.repl_feed_timeout:
                    return False  # the primary's feed is alive
            try:
                F.fire("repl.promote")
            except F.InjectedThreadDeath:
                raise
            except Exception:  # lint: allow-broad-except(injected promote fault; client retries)
                # the fault fires BEFORE any state flips: still a
                # standby, and the failing-over client simply retries
                return False
            self.term = int(self.term) + 1
            self.role = "primary"
            self._promote_local_state_locked()
            for eng in self._tenant_by_id.values():
                # tenants promote with their front: same term, and their
                # own in-flight drains go on the vacancy clock too
                with eng._lock:
                    eng.role = "primary"
                    eng.term = self.term
                    eng._promote_local_state_locked()
            if self._wal is not None and self._repl_log is None:
                # a DR standby promoting over its shipped-tail WAL
                # becomes a durable primary on the spot: new transitions
                # write through to the SAME on-disk sequence the feed
                # left off at (docs/FEDERATION.md "Cell-kill recovery")
                self._repl_log = ReplicationLog(metrics=self.metrics,
                                                wal=self._wal)
                for eng in self._engines():
                    eng._repl_log = TenantTaggedLog(self._repl_log,
                                                    eng.tenant_id)
            self.metrics.inc("promotions")
            term = self.term
        telemetry.event("promoted", term=term)
        return True

    def _promote_local_state_locked(self) -> None:
        """Post-promotion bookkeeping shared by the front server and its
        tenant engines: every lease is vacant on the promoted peer, so
        each un-drained participant of an in-flight barrier goes on the
        membership_timeout clock (one that never fails over must not
        deadlock the drain)."""
        rs = self._reshard
        if rs is not None and rs.get("phase") == "drain":
            now = self._clock()
            for r in rs["targets"]:
                if r not in rs["drained"] and r not in rs["dead"]:
                    self._vacated.setdefault(r, now)

    def _standby_refusal(self) -> dict:
        with self._lock:
            pa = self._primary_addr
            return {
                "code": "standby",
                "retry_ms": self.backpressure.retry_ms("standby"),
                "term": int(self.term),
                "primary": (list(pa) if pa is not None else None),
                "detail": "this server is a hot standby; data ops are "
                          "refused until a promotion",
            }

    def _term_refusal(self, header: dict) -> Optional[dict]:
        """The fencing gate on every mutating request (docs/RESILIENCE.md
        "Split-brain fencing").  Returns the ERROR header to refuse with,
        or None when the request may proceed."""
        t = header.get("term")
        with self._lock:
            if self._fenced_term is not None:
                refusal = {
                    "code": "fenced", "term": int(self._fenced_term),
                    "serving": False,
                    "detail": "this server was superseded by a promotion "
                              f"to term {self._fenced_term}; fail over",
                }
            elif t is not None and int(t) > self.term:
                # the request rode through a promotion this server never
                # saw — so this server IS the zombie: fence it on the spot
                self._fenced_term = int(t)
                refusal = {
                    "code": "fenced", "term": int(t), "serving": False,
                    "detail": f"request term {t} proves a newer primary "
                              "exists; this server is fenced",
                }
            elif t is not None and int(t) < self.term:
                return {
                    "code": "fenced", "term": int(self.term),
                    "serving": True,
                    "detail": f"request term {t} is stale; adopt term "
                              f"{self.term} and retry",
                }
            else:
                return None
        # a zombie refusing a write — the chaos matrix's injection point
        try:
            F.fire("server.zombie_write")
        except F.InjectedThreadDeath:
            raise
        except Exception:  # lint: allow-broad-except(injected fault must not un-refuse)
            pass
        self.metrics.inc("fenced_writes")
        return refusal

    # ------------------------------------------------ multi-cell federation
    def _cell_dir(self):
        """The live ``CellDirectory`` this server consults, or None when
        unfederated.  ``cell_directory`` is duck-typed: a
        ``DirectoryRef``-like holder (has ``current()``) or a static
        directory value — so the service layer never imports
        ``federation`` (docs/FEDERATION.md)."""
        d = self._cell_directory
        if d is None:
            return None
        return d.current() if hasattr(d, "current") else d

    def _cell_fields(self) -> dict:
        """Additive WELCOME fields naming this server's cell and the
        directory wire form — a federated client learns the global
        namespace from its very first claim; zero bytes unfederated."""
        if self.cell_id is None:
            return {}
        out = {"cell": self.cell_id}
        d = self._cell_dir()
        if d is not None:
            out["cell_directory"] = d.to_wire()
        return out

    def _cell_refusal(self, header: dict) -> Optional[dict]:
        """The cell gate on HELLO (docs/FEDERATION.md "Cell directory"):
        a tenant homed at another cell gets the typed retryable
        ``wrong_cell`` redirect carrying the home cell and the directory
        wire form — ``wrong_shard``'s exact shape, one layer up.  A
        failover HELLO is exempt: a client whose home cell just died
        must be able to knock at the DR cell BEFORE the directory
        flips — the promotion gate (feed staleness) is the safety
        there, not the gate."""
        if self.cell_id is None or header.get("failover"):
            return None
        d = self._cell_dir()
        if d is None:
            return None
        tenant = header.get("tenant")
        if tenant is None:
            fp = header.get("spec_fingerprint")
            tenant = (tenant_id_for(str(fp)) if fp is not None
                      else self.tenant_id)
        home = d.home(str(tenant))
        if home == self.cell_id:
            return None
        self.metrics.inc("cell_redirects")
        return {
            "code": "wrong_cell",
            "retry_ms": self.backpressure.retry_ms("wrong_cell"),
            "cell": self.cell_id,
            "home": home,
            "cell_directory": d.to_wire(),
            "detail": f"tenant {tenant} is homed at cell {home!r}; this "
                      f"is cell {self.cell_id!r} (directory v{d.version})",
        }

    def freeze_writes(self, on: bool = True) -> None:
        """The migration cutover barrier (docs/FEDERATION.md "Live
        migration"): while frozen, mutating client ops answer the
        retryable ``reshard`` refusal — HELLO excepted, so redirected
        clients can still land and wait — and the WAL tail goes
        quiescent so the shipper can drain it to the target cell."""
        if on:
            self._cell_frozen.set()
        else:
            self._cell_frozen.clear()

    def _apply_state_locked(self, state: dict) -> None:
        """Adopt a full replicated state dict (REPL_SYNC bootstrap, or a
        ``state`` WAL record carrying a reshard drain-flip/commit).
        Trusting by design — the feed already carries a winning term."""
        pa = state.get("primary_addr")
        if pa is not None:
            self._primary_addr = (str(pa[0]), int(pa[1]))
        wire = state.get("spec")
        if wire is not None:
            theirs = PartialShuffleSpec.from_wire(
                wire, backend=self.spec.backend)
            if theirs.world != self.spec.world:
                self.spec = self.spec.with_world(theirs.world)
        self.epoch = int(state.get("epoch", 0))
        self.generation = int(state.get("generation", 0))
        self.term = max(self.term, int(state.get("term", 0)))
        self.layers = [(int(w), int(c))
                       for w, c in state.get("layers") or []]
        ee = state.get("elastic_epoch")
        self.elastic_epoch = None if ee is None else int(ee)
        self._orphans = [dict(o) for o in state.get("orphans") or []]
        self._cap_records = {
            int(r): {"epoch": int(c["epoch"]), "gen": int(c["gen"]),
                     "total": int(c["total"])}
            for r, c in (state.get("capabilities") or {}).items()
        }
        self._cursors = {
            int(r): _cursor_from_wire(c)
            for r, c in (state.get("cursors") or {}).items()
        }
        for r, b in (state.get("leases") or {}).items():
            l = self._leases.setdefault(
                int(r), {"owner": None, "last_seen": self._clock(),
                         "batch": 0})
            l["batch"] = int(b)
        st = state.get("stream")
        if self.streaming and st is not None:
            self._stream_appended = int(st.get("appended", 0))
            self._stream_seqs = {str(k): int(v)
                                 for k, v in (st.get("seqs") or {}).items()}
            p = st.get("pending")
            self._stream_pending = (None if p is None
                                    else [int(x) for x in p])
            w = st.get("weights") or {}
            if w:
                self.spec = self.spec.with_stream_weights(
                    {int(g): tuple(int(x) for x in ws)
                     for g, ws in w.items()})
        sm = state.get("sampling")
        if self.sampling and sm is not None:
            w = sm.get("weights") or {}
            if w:
                self.spec = self.spec.with_stream_weights(
                    {int(g): tuple(int(x) for x in ws)
                     for g, ws in w.items()})
            bw = sm.get("dedup")
            if bw is not None and hasattr(self.spec, "with_dedup_boundary"):
                self.spec = self.spec.with_dedup_boundary(
                    int(bw["epoch"]), bw["seen"])
        rs = state.get("reshard")
        if rs is not None:
            self._reshard = {
                "phase": "drain",
                "target_world": int(rs["target_world"]),
                "epoch": int(rs["epoch"]),
                "barrier_units": int(rs["barrier_units"]),
                "targets": {int(r): int(t)
                            for r, t in rs["targets"].items()},
                "drained": {int(r) for r in rs.get("drained", [])},
                "dead": {int(r) for r in rs.get("dead", [])},
                "leaving": {int(r): None for r in rs.get("leaving", [])},
            }
        else:
            self._reshard = None
        for tid, tstate in (state.get("tenants") or {}).items():
            self._apply_tenant_state_locked(str(tid), dict(tstate))

    def _apply_record_locked(self, rec: dict) -> None:
        tid = rec.get("tenant")
        if tid is not None and rec.get("op") != "tenant":
            # a tenant engine's record: route it to this side's mirror
            # of that tenant (tag stripped — the engine's own handlers
            # key on rank/epoch only)
            eng = self._tenant_by_id.get(str(tid))
            if eng is not None and eng is not self:
                with eng._lock:
                    eng._apply_record_locked(
                        {k: v for k, v in rec.items() if k != "tenant"})
            return
        op = rec.get("op")
        if op == "epoch":
            self.epoch = int(rec["epoch"])
        elif op == "lease":
            l = self._leases.setdefault(
                int(rec["rank"]), {"owner": None,
                                   "last_seen": self._clock(), "batch": 0})
            l["batch"] = int(rec.get("batch") or 0)
            l["last_seen"] = self._clock()
        elif op == "lease_release":
            l = self._leases.get(int(rec["rank"]))
            if l is not None:
                l["owner"] = None
            self._vacated.setdefault(int(rec["rank"]), self._clock())
        elif op == "cursor":
            self._cursors[int(rec["rank"])] = _cursor_from_wire(rec)
        elif op == "state":
            self._apply_state_locked(rec.get("state") or {})
        elif op == "seal":
            self._seal_pending = True
        elif op == "tenant":
            # tenant creation on the primary: mirror the full engine
            # state (spec wire included) so failover restores it
            self._apply_tenant_state_locked(
                str(rec.get("tenant")), dict(rec.get("state") or {}))
        elif op == "capability":
            # an issued-capability grant: the mirror must keep applying
            # the consumption slack to this rank's ack-only cursor, or
            # a promoted standby would commit barriers below what the
            # capability client locally delivered (docs/CAPABILITY.md)
            self._cap_records[int(rec["rank"])] = {
                "epoch": int(rec["epoch"]), "gen": int(rec["gen"]),
                "total": int(rec["total"]),
            }
        elif op == "stream":
            # moving-horizon records (docs/STREAMING.md) carry ABSOLUTE
            # totals and per-feeder seq maxima, so a dropped/torn append
            # record is re-established by the next one — replay can only
            # under-count, and the eligibility gate then serves later,
            # never a sample twice
            self._stream_appended = max(self._stream_appended,
                                        int(rec.get("appended", 0)))
            for k, v in (rec.get("seqs") or {}).items():
                self._stream_seqs[str(k)] = max(
                    self._stream_seqs.get(str(k), -1), int(v))
            if "pending" in rec:
                p = rec.get("pending")
                self._stream_pending = (None if p is None
                                        else [int(x) for x in p])
            ep = rec.get("epoch")
            if ep is not None:
                # an advance record: adopt the folded weights first,
                # then the horizon generation (the pending delta it
                # consumed is spent)
                w = rec.get("weights")
                if w is not None and self.streaming:
                    self.spec = self.spec.with_stream_weights(
                        {int(ep): tuple(int(x) for x in w)})
                self.epoch = max(self.epoch, int(ep))
                self._stream_pending = None
        elif op == "sampling":
            # a prioritized re-weight adopted at SET_EPOCH
            # (docs/SAMPLING.md): the folded EFFECTIVE weights ride the
            # record, so replay adopts the same alias table without
            # re-deriving the fold — idempotent under re-application
            w = rec.get("weights")
            if w is not None and self.sampling:
                self.spec = self.spec.with_stream_weights(
                    {int(rec["epoch"]): tuple(int(x) for x in w)})
            self.epoch = int(rec["epoch"])
        elif op == "autopilot":
            # a controller decision (autopilot/controller.py): keep the
            # NEWEST policy state only — a promoted standby seeds its
            # own controller from it, so the decision stream continues
            # instead of restarting cold (docs/AUTOPILOT.md).  Knob
            # values ride the record too: the mirror advertises the
            # same tuned batch/inflight its primary did.
            st = rec.get("pstate")
            if st is not None:
                self._autopilot_state = dict(st)
            kn = rec.get("knobs") or {}
            if kn.get("max_inflight") is not None:
                self.max_inflight = max(1, int(kn["max_inflight"]))
            if kn.get("batch_hint") is not None:
                self._batch_hint = max(1, int(kn["batch_hint"]))
            if kn:
                self._advertise_knobs = True
        # unknown ops fall through: the record vocabulary is additive

    def _on_repl_sync(self, sock, header) -> None:
        term = int(header.get("term", 0))
        with self._lock:
            if self.role == "primary" or term < self.term:
                P.send_msg(sock, P.MSG_ERROR, {
                    "code": "fenced", "term": int(self.term),
                    "serving": self.role == "primary",
                    "detail": "REPL_SYNC from a superseded primary",
                })
                return
            self._apply_state_locked(header.get("state") or {})
            self.term = max(self.term, term)
            self._applied_lsn = int(header.get("lsn", 0))
            self._feed_last = self._clock()
            applied = self._applied_lsn
        telemetry.event("repl_synced", lsn=applied, term=term)
        P.send_msg(sock, P.MSG_OK, {"applied_lsn": applied})

    def _on_repl_append(self, sock, header) -> None:
        term = int(header.get("term", 0))
        with self._lock:
            if self.role == "primary" or term < self.term:
                P.send_msg(sock, P.MSG_ERROR, {
                    "code": "fenced", "term": int(self.term),
                    "serving": self.role == "primary",
                    "detail": "REPL_APPEND from a superseded primary",
                })
                return
            self.term = max(self.term, term)
            self._feed_last = self._clock()
            recs = header.get("records") or []
            from_lsn = int(header.get("from_lsn", 0))
            if recs and from_lsn > self._applied_lsn + 1:
                P.send_msg(sock, P.MSG_ERROR, {
                    "code": "repl_gap",
                    "applied_lsn": int(self._applied_lsn),
                    "detail": f"append starts at lsn {from_lsn}; applied "
                              f"prefix ends at {self._applied_lsn}",
                })
                return
            fresh = []
            for rec in recs:
                lsn = int(rec.get("lsn", 0))
                if lsn <= self._applied_lsn:
                    continue  # idempotent overlap after a re-SYNC
                self._apply_record_locked(rec)
                self._applied_lsn = lsn
                fresh.append(rec)
            applied = self._applied_lsn
            seal, self._seal_pending = self._seal_pending, False
            sealed = []
            for eng in self._tenant_by_id.values():
                if eng._seal_pending:
                    eng._seal_pending = False
                    sealed.append(eng)
        wal = self._wal
        if wal is not None:
            # receive-side write-through (docs/FEDERATION.md): a standby
            # with its own WAL persists each applied record before the
            # ack, so the shipped tail survives this cell losing its
            # feed.  The lsn guard keeps the on-disk sequence dense
            # through re-SYNC overlaps; noop fillers absorb any lsns the
            # feed's cursor coalescing skipped.  Outside self._lock —
            # the primary's append path orders repl-log before WAL too.
            for rec in fresh:
                if int(rec.get("lsn", 0)) > wal.last_lsn:
                    wal.append(rec)
        if seal:
            self._write_snapshot(force=True)
        for eng in sealed:
            eng._write_snapshot(force=True)
        P.send_msg(sock, P.MSG_OK, {"applied_lsn": applied})

    def _on_repl_promote(self, sock, header) -> None:
        if self.role == "primary":
            P.send_msg(sock, P.MSG_OK,
                       {"promoted": False, "term": int(self.term),
                        "detail": "already primary"})
            return
        if self._try_promote(force=bool(header.get("force"))):
            P.send_msg(sock, P.MSG_OK,
                       {"promoted": True, "term": int(self.term)})
        else:
            P.send_msg(sock, P.MSG_ERROR, self._standby_refusal())

    # ------------------------------------------------------------ the cache
    def _gen_layers_locked(self, epoch: int):
        """The cascade that applies to ``epoch`` (None for every other
        epoch — layers describe ONE epoch's partial consumption)."""
        if self.layers and epoch == self.elastic_epoch:
            return list(self.layers)
        return None

    def _orphan_len_locked(self, epoch: int) -> int:
        return sum(int(o["hi"]) - int(o["lo"]) for o in self._orphans
                   if int(o["epoch"]) == epoch)

    def _orphan_slice(self, spec: PartialShuffleSpec, o: dict):
        """Regenerate one orphan descriptor: the un-drained slice of a
        dead rank's stream in the generation it was defined."""
        s = spec.with_world(int(o["world"]))
        layers = [(int(w), int(c)) for w, c in o.get("layers") or []]
        arr = s.rank_indices(int(o["epoch"]), int(o["rank"]),
                             layers=layers or None)
        return np.asarray(arr)[int(o["lo"]):int(o["hi"])]

    def _rank_array(self, epoch: int, rank: int):
        with self._lock:
            spec = self.spec
            gen = self.generation
            layers = self._gen_layers_locked(int(epoch))
            orphans = ([dict(o) for o in self._orphans
                        if int(o["epoch"]) == int(epoch)]
                       if rank == 0 else [])
        key = (gen, int(epoch), int(rank))
        with self._gen_lock:
            arr = self._cache.get(key)
            if arr is not None:
                self._cache.move_to_end(key)
                return arr
            # cache miss → real regen work: multi-tenant daemons run it
            # through the fair-share queue so one tenant's huge regen
            # cannot starve another's (cache hits never queue, and a
            # single-tenant daemon has no scheduler — zero new cost)
            sched = self._regen_sched
            slot = (sched.slot(self.tenant_id, cost=self._regen_cost(),
                               clock=time.perf_counter)
                    if sched is not None else nullcontext())
            extra = ({"tenant": self.tenant_id} if sched is not None
                     else {})
            with slot:
                # t0 after the queue wait: epoch_regen_ms stays a pure
                # regen timing (queue time lands in regen_queue_ms)
                t0 = time.perf_counter()
                with _span("server.epoch_regen", epoch=int(epoch),
                           rank=int(rank), generation=gen, **extra):
                    with self.metrics.regen_timer.measure():
                        arr = np.asarray(spec.rank_indices(epoch, rank,
                                                           layers=layers))
                        if orphans:
                            # dead ranks' un-drained allocations ride as
                            # a prefix of rank 0's stream — every index
                            # still served once
                            parts = [self._orphan_slice(spec, o)
                                     for o in orphans]
                            arr = np.concatenate(parts + [arr])
                        elif spec.backend == "cuda":
                            # the readback lands in a pinned buffer of
                            # the caching host allocator: the cache keeps
                            # a pageable copy, so the buffer goes back to
                            # the allocator for the next regen and the
                            # daemon pins no cached epoch
                            arr = arr.copy()
            self.metrics.registry.histogram("epoch_regen_ms").observe(
                (time.perf_counter() - t0) * 1e3)
            arr.setflags(write=False)
            self._cache[key] = arr
            while len(self._cache) > self._max_cached:
                self._cache.popitem(last=False)
            return arr

    # --------------------------------------------------------------- accept
    def _on_accept_tick(self) -> None:
        # DispatchListener hook: the accept timeout is the sweep tick
        self._sweep_leases()

    def _sweep_leases(self) -> None:
        """Evict ranks whose connection went silent past the lease timeout
        and close their sockets (frees the rank AND unblocks the reader)."""
        now = self._clock()
        to_close = []
        with self._lock:
            for rank, lease in self._leases.items():
                owner = lease.get("owner")
                if owner is None:
                    continue
                if now - lease["last_seen"] > self.heartbeat_timeout:
                    lease["owner"] = None
                    self._vacated.setdefault(rank, now)
                    self._repl_append("lease_release", rank=rank)
                    self.metrics.inc("evictions", rank)
                    # eviction ends the rank's tenure: archive its
                    # per-client counters (AFTER counting the eviction,
                    # so the archive includes it)
                    self.metrics.drop_client(rank)
                    sock = self._conn_socks.get(owner)
                    if sock is not None:
                        to_close.append(sock)
        for sock in to_close:
            try:
                sock.close()
            except OSError:
                pass
        self._sweep_membership(now)
        for eng in self._engines():
            # tenant engines have no accept loop of their own; the front
            # server's tick drives their eviction and membership sweeps
            eng._sweep_leases()

    def _sweep_membership(self, now: float) -> None:
        """Elastic liveness, on the accept-loop tick: convert dead drain
        participants (grace expired, or vacant past ``membership_timeout``)
        to orphans, commit a fully-drained barrier whose committing request
        died mid-flight, and trigger the eviction reshard for ranks vacant
        past ``membership_timeout`` — so a drain can never deadlock on a
        preempted host and a permanently-lost rank shrinks the world."""
        if self.role == "standby":
            # a standby mirrors the primary's decisions; it must not
            # commit or trigger barriers of its own until promoted
            return
        trigger = None
        committed = False
        with self._lock:
            rs = self._reshard
            if rs is not None and rs.get("phase") == "drain":
                dead0 = len(rs["dead"])
                for r in rs["targets"]:
                    if r in rs["drained"] or r in rs["dead"]:
                        continue
                    deadline = rs["leaving"].get(r)
                    if deadline is not None and now >= deadline:
                        rs["dead"].add(r)
                        continue
                    lease = self._leases.get(r)
                    vacant = lease is None or lease.get("owner") is None
                    if (vacant and self.membership_timeout is not None
                            and r in self._vacated
                            and now - self._vacated[r]
                            > self.membership_timeout):
                        rs["dead"].add(r)
                try:
                    committed = self._commit_reshard_locked()
                except F.InjectedThreadDeath:
                    raise
                except Exception:  # lint: allow-broad-except(injected commit fault; retried)
                    pass
                if not committed and len(rs["dead"]) > dead0:
                    self._repl_append("state",
                                      state=self._state_dict_locked())
            elif (rs is None and self.membership_timeout is not None
                    and self.spec.world > 1 and not self._draining.is_set()):
                gone = {
                    r for r, t0 in self._vacated.items()
                    if r < self.spec.world
                    and now - t0 > self.membership_timeout
                    and (self._leases.get(r) is None
                         or self._leases[r].get("owner") is None)
                }
                if gone:
                    trigger = (max(1, self.spec.world - len(gone)), gone)
        if committed:
            self._write_snapshot(force=True)
        if trigger is not None:
            try:
                self._trigger_reshard(trigger[0], dead=trigger[1])
            except F.InjectedThreadDeath:
                raise
            except Exception:  # lint: allow-broad-except(injected trigger fault; sweep re-arms)
                pass

    # ------------------------------------------------------- per-connection
    # the serve loop itself lives in DispatchListener (service/dispatch.py);
    # these hooks bind it to tenant routing, batch timing and lease release
    def _conn_engine(self, conn_id: int) -> "IndexServer":
        return (self._conn_tenant.get(conn_id, self)
                if self.multi_tenant else self)

    def _span_extra(self, eng) -> dict:
        return {"tenant": eng.tenant_id} if self.multi_tenant else {}

    def _observe_dispatch(self, eng, msg, t0: float) -> None:
        if msg == P.MSG_GET_BATCH:
            eng.metrics.registry.histogram(
                "batch_service_ms"
            ).observe((time.perf_counter() - t0) * 1e3)

    def _conn_cleanup(self, conn_id: int) -> None:
        teng = self._conn_tenant.pop(conn_id, None)
        if teng is not None:
            teng._release_conn(conn_id)
        self._release_conn(conn_id)

    def _release_conn(self, conn_id: int) -> None:
        """A closed connection releases its leases at once — a crashed
        client's replacement must not wait out the heartbeat timeout."""
        with self._lock:
            self._conn_socks.pop(conn_id, None)
            for rank, lease in self._leases.items():
                if lease.get("owner") == conn_id:
                    lease["owner"] = None
                    self._vacated.setdefault(rank, self._clock())
                    self._repl_append("lease_release", rank=rank)

    def _touch(self, rank: int, lease: dict) -> None:
        now = self._clock()
        if now - lease["last_seen"] > self.heartbeat_timeout:
            # the client went silent past the lease but came back before
            # anything evicted it — a heartbeat gap worth counting
            self.metrics.inc("heartbeat_gaps", rank)
        lease["last_seen"] = now

    def _dispatch(self, sock, conn_id, msg, header, payload) -> None:
        if self._draining.is_set():
            # graceful drain: answer every request arriving during the
            # stop() window with a structured "retry shortly" instead of
            # letting the imminent socket close read as a raw reset
            P.send_msg(sock, P.MSG_ERROR, {
                "code": "draining",
                "detail": "server is stopping; reconnect shortly",
                "retry_ms": self.backpressure.retry_ms("draining"),
            })
            return
        if msg == P.MSG_REPL_SYNC:
            self._on_repl_sync(sock, header)
            return
        if msg == P.MSG_REPL_APPEND:
            self._on_repl_append(sock, header)
            return
        if msg == P.MSG_REPL_PROMOTE:
            self._on_repl_promote(sock, header)
            return
        if msg in _MUTATING_MSGS:
            if self.role == "standby":
                # a failover HELLO may promote (once the feed is stale);
                # everything else is refused until the promotion
                if not (msg == P.MSG_HELLO and header.get("failover")
                        and self._try_promote()):
                    P.send_msg(sock, P.MSG_ERROR, self._standby_refusal())
                    return
            refusal = self._term_refusal(header)
            if refusal is not None:
                _annotate(error_code="fenced")
                P.send_msg(sock, P.MSG_ERROR, refusal)
                return
            if self._cell_frozen.is_set() and msg != P.MSG_HELLO:
                # migration cutover freeze (docs/FEDERATION.md): the
                # same retryable refusal a reshard barrier uses, so the
                # client's existing retry arm pauses through the flip;
                # HELLO stays live — a redirected client must be able
                # to land and learn the post-flip directory
                P.send_msg(sock, P.MSG_ERROR, {
                    "code": "reshard",
                    "phase": "cell_freeze",
                    "retry_ms": self.backpressure.retry_ms("reshard_freeze"),
                    "detail": "cell cutover in progress; retry shortly",
                })
                return
        # tenant routing: the connection's HELLO binding wins; an
        # explicit additive ``tenant`` header field (mirroring ``trace``)
        # can name the namespace when a connection serves ops traffic
        engine = self
        if self._conn_tenant or self._tenant_by_id:
            engine = self._conn_tenant.get(conn_id, self)
            tid = header.get("tenant")
            if tid is not None:
                engine = self._tenant_by_id.get(str(tid), engine)
        if msg == P.MSG_HELLO:
            self._on_hello(sock, conn_id, header)
        elif msg == P.MSG_GET_BATCH:
            engine._on_get_batch(sock, conn_id, header)
        elif msg == P.MSG_SET_EPOCH:
            engine._on_set_epoch(sock, header)
        elif msg == P.MSG_HEARTBEAT:
            engine._on_heartbeat(sock, conn_id, header)
        elif msg == P.MSG_GET_CAPABILITY:
            engine._on_get_capability(sock, conn_id, header)
        elif msg == P.MSG_APPEND:
            engine._on_append(sock, header)
        elif msg == P.MSG_SNAPSHOT:
            engine._write_snapshot(force=True)
            P.send_msg(sock, P.MSG_SNAPSHOT_STATE,
                       {"state": engine._state_dict()})
        elif msg == P.MSG_METRICS:
            # a tenant-bound connection reads its own scoped report —
            # isolation; the front's report carries the tenant rollup
            P.send_msg(sock, P.MSG_METRICS_REPORT,
                       {"report": engine.metrics.report()})
        elif msg == P.MSG_LEAVE:
            engine._on_leave(sock, conn_id, header)
        elif msg == P.MSG_RESHARD:
            engine._on_reshard(sock, conn_id, header)
        elif msg == P.MSG_TRACE_DUMP:
            limit = int(header.get("limit", 256))
            entries = telemetry.snapshot(limit)
            if self.multi_tenant:
                # trace isolation: tenant-tagged spans of OTHER tenants
                # never leak into this connection's dump (untagged
                # entries are shared-infrastructure and stay visible)
                own = engine.tenant_id
                entries = [e for e in entries
                           if (e.get("attrs") or {}).get("tenant")
                           in (None, own)]
            P.send_msg(sock, P.MSG_TRACE_REPORT, {
                "enabled": telemetry.enabled(),
                "entries": entries,
            })
        else:
            P.send_msg(sock, P.MSG_ERROR, {
                "code": "unknown_type",
                "detail": f"message type {P.msg_name(msg)} not served",
            })

    def _on_set_epoch(self, sock, header) -> None:
        delta = header.get("weights_delta")
        folded = None
        with self._lock:
            if delta is not None:
                # prioritized re-weighting (docs/SAMPLING.md): the
                # additive delta folds into the weights EFFECTIVE at the
                # new epoch — the streaming advance's fold law applied
                # at an epoch boundary.  Weights stay >= 1 so no source
                # is silently starved to zero by a large negative delta.
                if (not self.sampling
                        or getattr(self.spec, "sampling_mode", None)
                        != "prioritized"):
                    P.send_msg(sock, P.MSG_ERROR, {
                        "code": "bad_request",
                        "detail": "weights_delta requires a prioritized "
                                  "sampling spec",
                    })
                    return
                new_epoch = int(header.get("epoch", 0))
                base = self.spec.effective_weights(new_epoch)
                if len(delta) != len(base):
                    P.send_msg(sock, P.MSG_ERROR, {
                        "code": "bad_request",
                        "detail": f"weights_delta has {len(delta)} "
                                  f"entries for {len(base)} sources",
                    })
                    return
                from ..streaming.spec import WEIGHTS_RETAIN

                folded = tuple(max(1, int(a) + int(b))
                               for a, b in zip(base, delta))
                self.spec = self.spec.with_stream_weights(
                    {new_epoch: folded},
                    prune_below=new_epoch - WEIGHTS_RETAIN // 2)
                self.metrics.inc("sampling_reweights")
            self.epoch = int(header.get("epoch", 0))
            if folded is not None:
                self._repl_append("sampling", epoch=self.epoch,
                                  weights=[int(x) for x in folded])
            else:
                self._repl_append("epoch", epoch=self.epoch)
        self._write_snapshot(force=True)
        reply = {"epoch": self.epoch}
        if folded is not None:
            reply["weights"] = [int(x) for x in folded]
        P.send_msg(sock, P.MSG_OK, reply)

    def _ack_advance_locked(self, rank: int, lease: dict, epoch, ack) -> bool:
        """Advance ``rank``'s delivered-ack cursor for ``epoch`` and, if
        that satisfies a drain barrier's ack gate, complete the rank's
        drain.  Returns True when this ack committed the barrier.
        Shared by HEARTBEAT and the ``hb`` field piggybacked on
        GET_BATCH/HEARTBEAT; caller holds ``self._lock``."""
        committed = False
        cur = self._cursors.get(rank)
        if cur is None or cur["epoch"] != int(epoch):
            return False
        cur["acked"] = max(cur["acked"], int(ack))
        rec = self._cap_records.get(rank)
        if (rec is not None and int(rec["epoch"]) == int(epoch)
                and int(rec["gen"]) == self.generation):
            # capability-mode rank: no batches flow, so the served-
            # samples watermark an elastic barrier cuts on is maintained
            # from the acks, with a slack of ``max_inflight`` batches —
            # the client never locally delivers further past its last
            # flushed ack (docs/CAPABILITY.md "Drain law"), so the
            # barrier C covers every sample it may have consumed
            b = int(lease.get("batch") or 0)
            slack = min((cur["acked"] + 1 + self.max_inflight) * b,
                        int(rec["total"]))
            cur["samples"] = max(int(cur.get("samples", 0)), slack)
        self._repl_append("cursor", rank=rank, **cur)
        rs = self._reshard
        if (rs is not None and rs.get("phase") == "drain"
                and int(epoch) == rs["epoch"]
                and rank in rs["targets"]
                and rank not in rs["drained"]
                and (cur["acked"] + 1) * int(lease.get("batch") or 0)
                >= int(rs["targets"][rank])):
            rs["drained"].add(rank)
            try:
                committed = self._commit_reshard_locked()
            except F.InjectedThreadDeath:
                raise
            except Exception:  # lint: allow-broad-except(injected commit fault; retried)
                pass
            if not committed:
                self._repl_append("state", state=self._state_dict_locked())
        return committed

    def _apply_piggyback_ack(self, conn_id, rank, hb) -> None:
        """Apply a piggybacked ``hb: [epoch, ack]`` header field — a
        delivered-ack cursor for an epoch OTHER than the one the
        carrying request is about (typically the previous epoch's
        terminal ack, deferred by the pipelined client instead of a
        dedicated EOF poll).  Re-application is idempotent (the cursor
        is a max), so a retried request may carry the same ``hb``."""
        if hb is None or rank is None:
            return
        try:
            hb_epoch, hb_ack = int(hb[0]), int(hb[1])
        except (TypeError, ValueError, IndexError):
            return  # malformed piggyback: ignore, the request stands alone
        committed = False
        with self._lock:
            lease = self._leases.get(int(rank))
            if lease is not None and lease.get("owner") == conn_id:
                committed = self._ack_advance_locked(
                    int(rank), lease, hb_epoch, hb_ack)
        if committed:
            self._write_snapshot(force=True)

    def _on_heartbeat(self, sock, conn_id, header) -> None:
        """Keepalive, optionally carrying the client's delivered-ack
        cursor (``epoch`` + ``ack``).  The ack matters during a drain:
        the barrier commits on ACKED delivery, and a participant that
        stopped pulling batches (idle at its watermark when the barrier
        froze) would otherwise never deliver the final ack that
        completes its drain."""
        rank = header.get("rank")
        self._apply_piggyback_ack(conn_id, rank, header.get("hb"))
        committed = False
        with self._lock:
            lease = self._leases.get(int(rank)) if rank is not None \
                else None
            if lease is not None and lease.get("owner") == conn_id:
                rank = int(rank)
                self._touch(rank, lease)
                ack, epoch = header.get("ack"), header.get("epoch")
                if ack is not None and epoch is not None:
                    committed = self._ack_advance_locked(
                        rank, lease, epoch, ack)
            gen = self.generation
            reply = {"generation": gen}
            kn = self._knob_fields()
            if kn:
                # additive: autopilot-tuned knobs ride the keepalive so
                # live clients adopt them without reconnecting; absent
                # until a controller first touches one, so a disabled
                # autopilot costs zero protocol bytes (docs/AUTOPILOT.md)
                reply["knobs"] = kn
            rs = self._reshard
            rec = (self._cap_records.get(int(rank))
                   if rank is not None else None)
            if (rec is not None and rs is not None
                    and rs.get("phase") == "drain"
                    and int(rank) in rs["targets"]
                    and int(rec["epoch"]) == int(rs["epoch"])):
                # a batchless capability stream discovers its drain
                # clamp here (served-batch clients get it from the
                # GET_BATCH clamp instead): additive field, absent
                # outside a drain (docs/CAPABILITY.md "Drain law")
                reply["cap_drain"] = {
                    "epoch": int(rs["epoch"]),
                    "target_samples": int(rs["targets"][int(rank)]),
                }
        if committed:
            self._write_snapshot(force=True)
        P.send_msg(sock, P.MSG_OK, reply)

    # ----------------------------------------------------------- capability
    def _capability_locked(self, epoch: int) -> EpochCapability:
        """The signed grant for the CURRENT membership — one HMAC over
        the canonical encoding (docs/CAPABILITY.md).  Under
        ``self._lock``."""
        extra = {}
        if self.streaming or self.sampling:
            # the effective weights ride the grant — horizon mixture
            # weights (docs/STREAMING.md) or adopted prioritized
            # sampling weights (docs/SAMPLING.md): regen on the client
            # substitutes them before evaluating, so a re-weighted
            # stream folds bit-identically on device.  Absent for
            # plain-base streams, for static sampling specs, and for
            # every frozen-dataset grant (old grants verify unchanged).
            w = self.spec.weights_for(int(epoch))
            if w is not None:
                extra["stream_weights"] = tuple(int(x) for x in w)
        secret = self.capability_secret
        if hasattr(secret, "current"):
            # federated issuance (docs/FEDERATION.md): the secret is a
            # CellKeyring — the cell + key id ride INSIDE the signed
            # bytes, so a promoted DR cell can keep honoring this grant
            # while a retired key fails verification loudly
            kid, secret = secret.current()
            extra["cell"] = (self.cell_id
                             or getattr(self.capability_secret,
                                        "cell_id", None))
            extra["kid"] = int(kid)
        return EpochCapability(
            fingerprint=self.spec.fingerprint(include_world=False),
            epoch=int(epoch),
            seed=int(self.spec.seed),
            generation=int(self.generation),
            world=int(self.spec.world),
            layers=tuple((int(w), int(c)) for w, c in self.layers),
            elastic_epoch=self.elastic_epoch,
            orphans=tuple(dict(o) for o in self._orphans),
            tenant=self.tenant_id,
            **extra,
        ).signed(secret)

    def _on_get_capability(self, sock, conn_id, header) -> None:
        """Issue a signed epoch capability (docs/CAPABILITY.md): the
        client regenerates its indices on-device and reports only ack
        watermarks, so issuance must create the rank's epoch cursor (an
        ack against a missing cursor is dropped by
        :meth:`_ack_advance_locked`, which would stall drain barriers)
        and persist an issued-capability record so a restarted or
        promoted daemon keeps honoring the grant."""
        try:
            rank = int(header["rank"])
            epoch = int(header["epoch"])
        except (KeyError, TypeError, ValueError):
            P.send_msg(sock, P.MSG_ERROR,
                       {"code": "bad_request",
                        "detail": "GET_CAPABILITY needs rank/epoch ints"})
            return
        if self.capability_secret is None:
            # terminal by design: an unsigned grant would let any client
            # forge membership, so a secretless daemon only serves the
            # batch path — and puts zero capability bytes on the wire
            _annotate(error_code="capability_unsupported")
            P.send_msg(sock, P.MSG_ERROR, {
                "code": "capability_unsupported",
                "detail": "this daemon has no capability_secret "
                          "configured; use the served-batch path",
            })
            return
        try:
            F.fire("capability.issue")
        except F.InjectedThreadDeath:
            raise
        except Exception as exc:
            self.metrics.inc("capability_rejects", rank)
            _annotate(error_code="capability_issue")
            P.send_msg(sock, P.MSG_ERROR, {
                "code": "capability_issue",
                "retry_ms": self.backpressure.retry_ms("capability_issue"),
                "detail": f"capability issuance refused ({exc!r}); retry",
            })
            return
        t0 = time.perf_counter()
        advanced = False
        with self._lock:
            lease = self._leases.get(rank)
            if lease is None or lease.get("owner") != conn_id:
                P.send_msg(sock, P.MSG_ERROR, {
                    "code": "not_owner",
                    "detail": f"rank {rank} is not leased to this "
                              "connection; HELLO first",
                })
                return
            self._touch(rank, lease)
            if self.streaming:
                # eligibility + ack-gated advance, BEFORE any cursor
                # mutation (docs/STREAMING.md): a refused request leaves
                # the stream state exactly as it found it
                refusal, advanced = self._stream_gate_locked(epoch)
                if refusal is not None:
                    P.send_msg(sock, P.MSG_ERROR, refusal)
                    return
            rs = self._reshard
            if rs is not None and rs.get("phase") == "freeze":
                # a grant issued mid-freeze could outrun the watermark
                # snapshot the freeze took; refuse like GET_BATCH does
                _annotate(error_code="reshard")
                P.send_msg(sock, P.MSG_ERROR, {
                    "code": "reshard",
                    "retry_ms":
                        self.backpressure.retry_ms("reshard_freeze"),
                    "detail": "reshard barrier is freezing; retry shortly",
                })
                return
            cur_gen = self.generation
        if advanced:
            # the horizon advance this request committed seals a forced
            # checkpoint (outside the lock — the writer retakes it) so
            # the WAL truncates below the new watermark
            self._stream_advanced(t0)
        # the rank's total (rank 0's orphan prefix included) anchors the
        # consumption slack; _rank_array takes self._lock, so this MUST
        # stay outside it
        total = int(self._rank_array(epoch, rank).shape[0])
        with self._lock:
            if self.generation != cur_gen:
                # a sweep committed a barrier while we computed: the
                # retry is issued against the fresh membership
                _annotate(error_code="reshard")
                P.send_msg(sock, P.MSG_ERROR, {
                    "code": "reshard",
                    "retry_ms":
                        self.backpressure.retry_ms("reshard_freeze"),
                    "detail": "reshard committed mid-issuance; retry",
                })
                return
            cur = self._cursors.get(rank)
            if cur is None or cur["epoch"] != epoch:
                cur = self._cursors[rank] = {"epoch": epoch, "acked": -1,
                                             "hi": -1, "samples": 0}
            batch = int(lease.get("batch") or 0)
            if self.streaming:
                # capability-mode ranks serve no slices, so the advance
                # barrier's per-rank target is pinned at issuance; the
                # ack-to-samples batch rides along for post-lease gating
                cur["total"] = int(total)
                cur["batch"] = batch
            # consumption floor: the client may locally deliver up to
            # max_inflight batches before its first ack flush, and a
            # barrier freezing in that window must still cover them
            floor = min((cur["acked"] + 1 + self.max_inflight) * batch,
                        total)
            cur["samples"] = max(int(cur.get("samples", 0)), floor)
            rec = {"epoch": epoch, "gen": cur_gen, "total": total}
            self._cap_records[rank] = rec
            self._repl_append("capability", rank=rank, **rec)
            self._repl_append("cursor", rank=rank, **cur)
            # the slot's acked cursor rides every grant: a new lease
            # holder adopting a partly-served slot (a vacated rank
            # mid-drain, a takeover after a client death) must resume
            # regeneration at acked+1, not replay from seq 0 — the
            # capability-mode half of the double-delivery guard
            hdr = {"capability": self._capability_locked(epoch).to_wire(),
                   "ack": int(cur["acked"]),
                   **self._membership_locked()}
            rs = self._reshard
            if (rs is not None and rs.get("phase") == "drain"
                    and epoch == rs["epoch"] and rank in rs["targets"]):
                hdr["target_samples"] = int(rs["targets"][rank])
            stale = (header.get("gen") is not None
                     and int(header["gen"]) != cur_gen)
        self.metrics.registry.histogram("capability_issue_ms").observe(
            (time.perf_counter() - t0) * 1e3)
        if stale:
            # revocation surface: the request named a revoked
            # generation — the typed retryable error carries the FRESH
            # capability, so adopting and resuming costs no second trip
            self.metrics.inc("capability_stale", rank)
            _annotate(error_code="capability_stale")
            P.send_msg(sock, P.MSG_ERROR, {
                "code": "capability_stale",
                "retry_ms": self.backpressure.retry_ms("capability_stale"),
                "detail": f"generation {header.get('gen')} was revoked "
                          f"(now at {cur_gen}); adopt the attached "
                          "membership and capability",
                **hdr,
            })
            return
        self.metrics.inc("capabilities_issued", rank)
        self._write_snapshot()
        P.send_msg(sock, P.MSG_CAPABILITY, hdr)

    # ------------------------------------------------- elastic membership
    def _membership_locked(self) -> dict:
        """The fields a client needs to adopt the current membership —
        rides in WELCOME and in every ``resharded`` error."""
        return {
            "generation": self.generation,
            "world": self.spec.world,
            "epoch": self.epoch,
            "layers": [[int(w), int(c)] for w, c in self.layers],
            "elastic_epoch": self.elastic_epoch,
            "orphans": [dict(o) for o in self._orphans],
            "vacated": sorted(int(r) for r in self._vacated),
        }

    def _resharded_err_locked(self, detail: str) -> dict:
        return {"code": "resharded", "detail": detail,
                **self._membership_locked()}

    def _consumption_locked(self, epoch: int, world: int):
        """Per-rank ``(samples, covered)`` watermarks at ``epoch`` —
        samples served vs samples ACKED delivered.  Under ``self._lock``."""
        samples = {
            r: (int(self._cursors[r].get("samples", 0))
                if r in self._cursors
                and self._cursors[r]["epoch"] == epoch else 0)
            for r in range(world)
        }
        covered = {}
        for r in range(world):
            cur = self._cursors.get(r)
            b = int(self._leases.get(r, {}).get("batch") or 0)
            covered[r] = (
                (int(cur["acked"]) + 1) * b
                if cur is not None and cur["epoch"] == epoch and b > 0
                else 0
            )
        return samples, covered

    def _unit_watermarks(self, epoch: int, world: int, layers,
                         orphan_len: int, samples: dict):
        """Per-rank unit cumsums (shard mode) and whole base units
        STARTED: sample ``s-1`` lives in unit ``u-1``.  Call OUTSIDE the
        lock — shard mode may regenerate the epoch's shard draws."""
        shard = self.spec.mode == "shard"
        cums = {}
        if shard:
            for r in range(world):
                sizes = np.asarray(self.spec.rank_unit_sizes(
                    epoch, r, layers=layers), dtype=np.int64)
                cums[r] = np.concatenate(([0], np.cumsum(sizes)))
        units = {}
        for r in range(world):
            s = max(0, samples[r] - (orphan_len if r == 0 else 0))
            units[r] = (int(np.searchsorted(cums[r], s, side="left"))
                        if shard else s)
        return cums, units

    def _reshard_prepare(self, target_world: int):
        """Phase 1 of a cross-shard barrier (docs/SHARDING.md): freeze
        serving and report this server's consumption maximum in whole
        base units.  Unlike :meth:`_trigger_reshard`, the frozen barrier
        does NOT flip to drain — the coordinating router gathers every
        shard's maximum, takes the global max ``C``, and imposes it via
        :meth:`_reshard_commit_prepared` (or unfreezes the abandoned
        prepare via :meth:`_reshard_abort_prepared`).  Returns ``None``
        when another reshard is already in flight, else
        ``{"epoch", "world", "units_max"}``."""
        F.fire("server.reshard")
        target_world = int(target_world)
        if target_world < 1:
            raise ValueError(f"target_world must be >= 1, got {target_world}")
        t_freeze = time.perf_counter()
        with self._lock:
            if self._reshard is not None or self._draining.is_set():
                return None
            world = self.spec.world
            epochs = [c["epoch"] for c in self._cursors.values()]
            epoch = max(epochs) if epochs else self.epoch
            self._reshard = {"phase": "freeze",
                             "target_world": target_world, "epoch": epoch}
            layers = self._gen_layers_locked(epoch)
            orphan_len = self._orphan_len_locked(epoch)
            samples, covered = self._consumption_locked(epoch, world)
        try:
            _cums, units = self._unit_watermarks(epoch, world, layers,
                                                 orphan_len, samples)
            with self._lock:
                rs = self._reshard
                if rs is None:  # aborted while we computed
                    return None
                # in-memory scratch only: _state_dict_locked persists
                # drain-phase barriers, so a daemon crashed mid-prepare
                # restarts unfrozen and the router simply retries
                rs["prep"] = {"epoch": int(epoch), "world": int(world),
                              "covered": covered, "t_freeze": t_freeze}
            return {"epoch": int(epoch), "world": int(world),
                    "units_max": int(max(units.values(), default=0))}
        except BaseException:
            # a failed prepare must unfreeze, or every future GET_BATCH
            # draws an endless retry and the shard is bricked
            with self._lock:
                self._reshard = None
            telemetry.auto_dump("reshard_abort")
            raise

    def _reshard_commit_prepared(self, barrier_units: int, *,
                                 participants=None, dead=None,
                                 leaving=None) -> bool:
        """Phase 2 of a cross-shard barrier: set per-rank drain targets
        from the imposed GLOBAL barrier ``C`` and flip the prepared
        freeze to drain.  ``participants`` restricts the drain gate to
        the ranks this server actually serves (its shard slice);
        ``dead`` adds coordinator-declared dead ranks whose un-served
        allocation is re-homed here as orphan descriptors (the router
        sends those only to the shard owning rank 0, where orphan
        prefixes are served).  The commit itself then proceeds exactly
        as a local reshard — whichever request or sweep observes the
        last drain wins.  Returns False when no prepared barrier is in
        flight."""
        barrier = int(barrier_units)
        with self._lock:
            rs = self._reshard
            if (rs is None or rs.get("phase") != "freeze"
                    or "prep" not in rs):
                return False
            prep = rs["prep"]
            epoch, world = prep["epoch"], prep["world"]
            layers = self._gen_layers_locked(epoch)
            orphan_len = self._orphan_len_locked(epoch)
        # shard-mode cumsums regenerate draws — outside the lock (the
        # prepared freeze pauses serving, so watermarks cannot move)
        shard = self.spec.mode == "shard"
        cums = {}
        if shard:
            for r in range(world):
                sizes = np.asarray(self.spec.rank_unit_sizes(
                    epoch, r, layers=layers), dtype=np.int64)
                cums[r] = np.concatenate(([0], np.cumsum(sizes)))
        ranks = sorted(
            {int(r) for r in (participants if participants is not None
                              else range(world))}
            | {int(r) for r in (dead or ())}
        )
        with self._lock:
            rs = self._reshard
            if rs is None or rs.get("phase") != "freeze":
                return False
            covered = prep["covered"]
            targets = {}
            now = self._clock()
            for r in ranks:
                t = int(cums[r][barrier]) if shard else barrier
                if r == 0:
                    t += orphan_len
                targets[r] = t
                lease = self._leases.get(r)
                if lease is None or lease.get("owner") is None:
                    self._vacated.setdefault(r, now)
            rs.pop("prep", None)
            rs.update(
                phase="drain",
                barrier_units=barrier,
                targets=targets,
                drained={r for r in ranks
                         if r not in set(dead or ()) and
                         covered.get(r, 0) >= targets[r]},
                leaving=dict(leaving or {}),
                dead={int(r) for r in (dead or ())},
            )
            rs["t_drain"] = time.perf_counter()
            self.metrics.inc("reshard_triggers")
            # the freeze→drain flip ships wholesale: the standby
            # applies barriers with the snapshot-restore code path
            self._repl_append("state", state=self._state_dict_locked())
        self.metrics.registry.histogram("barrier_freeze_ms").observe(
            (rs["t_drain"] - prep["t_freeze"]) * 1e3)
        telemetry.event("reshard_drain",
                        target_world=int(rs["target_world"]),
                        barrier_units=barrier)
        with self._lock:
            try:
                self._commit_reshard_locked()
            except F.InjectedThreadDeath:
                raise
            except Exception:  # lint: allow-broad-except(injected commit fault; retried)
                pass
        self._write_snapshot(force=True)
        return True

    def _reshard_abort_prepared(self) -> bool:
        """Unfreeze a prepared (phase-1) barrier the coordinator
        abandoned — e.g. a sibling shard refused its prepare.  A
        drain-phase barrier is never aborted here: it is already
        replicated and will commit through the normal drain path."""
        with self._lock:
            rs = self._reshard
            if rs is None or rs.get("phase") != "freeze":
                return False
            self._reshard = None
        telemetry.event("reshard_prepare_aborted")
        return True

    def _trigger_reshard(self, target_world: int, *, leaving=None,
                         dead=None) -> bool:
        """Freeze a reshard barrier and enter the drain phase.

        The barrier ``C`` is the max over all ranks' consumption
        watermarks converted to whole base units (samples, or SHARDS for
        shard mode — a barrier must cut on whole shards so the remainder
        expansion is exactly the expansion of the remainder shard IDs).
        Ranks behind ``C`` keep being served their old partition, clamped
        to their per-rank sample target; ranks at it wait out the commit.
        A rank counts as drained only up to its ACKED delivery — the
        served watermark may lead it by one lost-in-flight reply, and
        that span must stay resendable past the commit.
        Returns False when another reshard is already in flight."""
        F.fire("server.reshard")
        target_world = int(target_world)
        if target_world < 1:
            raise ValueError(f"target_world must be >= 1, got {target_world}")
        t_freeze = time.perf_counter()
        with self._lock:
            if self._reshard is not None or self._draining.is_set():
                return False
            world = self.spec.world
            epochs = [c["epoch"] for c in self._cursors.values()]
            # barrier at the epoch consumption is actually happening on
            # (ranks advance epochs together — docs/RESILIENCE.md)
            epoch = max(epochs) if epochs else self.epoch
            self._reshard = {"phase": "freeze",
                             "target_world": target_world, "epoch": epoch}
            layers = self._gen_layers_locked(epoch)
            orphan_len = self._orphan_len_locked(epoch)
            samples, covered = self._consumption_locked(epoch, world)
        try:
            # unit structure may regenerate shard draws — outside the lock
            # (the freeze phase pauses serving, so watermarks cannot move:
            # new requests are refused at admission, and a request already
            # past admission is refused at its counting tail)
            shard = self.spec.mode == "shard"
            cums, units = self._unit_watermarks(epoch, world, layers,
                                                orphan_len, samples)
            barrier = max(units.values(), default=0)
            with self._lock:
                rs = self._reshard
                targets = {}
                now = self._clock()
                for r in range(world):
                    t = int(cums[r][barrier]) if shard else int(barrier)
                    if r == 0:
                        t += orphan_len
                    targets[r] = t
                    lease = self._leases.get(r)
                    if lease is None or lease.get("owner") is None:
                        # a participant with no live lease at the barrier
                        # goes on the membership_timeout clock NOW — a
                        # rank that never connected at all would otherwise
                        # never be declared dead and stall the drain
                        self._vacated.setdefault(r, now)
                rs.update(
                    phase="drain",
                    barrier_units=int(barrier),
                    targets=targets,
                    drained={r for r in range(world)
                             if r not in set(dead or ()) and
                             covered[r] >= targets[r]},
                    leaving=dict(leaving or {}),
                    dead=set(dead or ()),
                )
                rs["t_drain"] = time.perf_counter()
                self.metrics.inc("reshard_triggers")
                # the freeze→drain flip ships wholesale: the standby
                # applies barriers with the snapshot-restore code path
                self._repl_append("state", state=self._state_dict_locked())
            self.metrics.registry.histogram("barrier_freeze_ms").observe(
                (rs["t_drain"] - t_freeze) * 1e3)
            telemetry.event("reshard_drain", target_world=target_world,
                            barrier_units=int(barrier))
        except BaseException:
            # any failure between the freeze and the drain flip (shard
            # regen, target computation) must unfreeze, or every future
            # GET_BATCH draws an endless retry and the server is bricked
            with self._lock:
                self._reshard = None
            telemetry.auto_dump("reshard_abort")
            raise
        with self._lock:
            try:
                self._commit_reshard_locked()
            except F.InjectedThreadDeath:
                raise
            except Exception:  # lint: allow-broad-except(injected commit fault; retried)
                pass
        self._write_snapshot(force=True)
        return True

    def _clip_orphans_locked(self, rank: int, lo: int, hi: int, world: int,
                             layers, epoch: int) -> list[dict]:
        """Descriptors for a dead rank's un-served span ``[lo, hi)`` of its
        current-generation stream.  Rank 0's stream is composite (orphan
        prefix + partition), so the span decomposes into clips of the old
        descriptors plus a partition descriptor — each over a PURE stream
        of some earlier generation, hence regenerable forever."""
        out: list[dict] = []
        off = 0
        if rank == 0:
            for o in self._orphans:
                if int(o["epoch"]) != epoch:
                    continue
                ln = int(o["hi"]) - int(o["lo"])
                a, b = max(lo, off), min(hi, off + ln)
                if a < b:
                    out.append({**o, "lo": int(o["lo"]) + a - off,
                                "hi": int(o["lo"]) + b - off})
                off += ln
        plo, phi = max(lo - off, 0), hi - off
        if phi > plo:
            out.append({
                "epoch": int(epoch), "rank": int(rank), "world": int(world),
                "layers": [[int(w), int(c)] for w, c in layers or []],
                "lo": int(plo), "hi": int(phi),
            })
        return out

    def _commit_reshard_locked(self) -> bool:
        """Commit a fully-drained barrier: append the §6 cascade layer,
        re-partition at the target world, bump the generation.  Idempotent
        and callable from any drain participant's request or the sweep —
        whichever observes the last drain wins.  Under ``self._lock``."""
        rs = self._reshard
        if rs is None or rs.get("phase") != "drain":
            return False
        for r in rs["targets"]:
            if r not in rs["drained"] and r not in rs["dead"]:
                return False
        F.fire("server.reshard")  # before any mutation: a fault here
        # leaves the drain intact for the sweep to re-commit
        epoch = int(rs["epoch"])
        old_world = self.spec.world
        old_layers = self._gen_layers_locked(epoch) or []
        new_orphans: list[dict] = []
        for r in sorted(rs["dead"]):
            t = int(rs["targets"][r])
            cur = self._cursors.get(r)
            s = (int(cur.get("samples", 0))
                 if cur is not None and cur["epoch"] == epoch else 0)
            s = min(s, t)
            if s < t:
                new_orphans.extend(self._clip_orphans_locked(
                    r, s, t, old_world, old_layers, epoch))
        self.layers = [(int(w), int(c)) for w, c in old_layers]
        self.layers.append((old_world, int(rs["barrier_units"])))
        self.elastic_epoch = epoch
        self.spec = self.spec.with_world(int(rs["target_world"]))
        self.generation += 1
        self._orphans = new_orphans
        self._cursors = {}
        self._vacated = {}
        # revocation: every outstanding capability named the committed-
        # away generation; clients re-fetch through ``capability_stale``
        # and issuance re-populates (and re-replicates) the records
        self._cap_records = {}
        now = self._clock()
        for rank in list(self._leases):
            if rank >= self.spec.world:
                self._leases.pop(rank)
            elif rank in rs["leaving"] or rank in rs["dead"]:
                # the departed rank's slot in the NEW world must be
                # claimable (the displaced top rank rejoins into it)
                if self._leases[rank].get("owner") is not None:
                    self._leases[rank]["owner"] = None
                self._vacated[rank] = now
        self._reshard = None
        if self.streaming and epoch == self.epoch:
            # re-pin the advance barrier's per-rank targets under the
            # NEW partition (docs/STREAMING.md "Advance under reshard"):
            # post-commit arrays hold only each rank's un-delivered
            # remainder share, served from seq 0, so every cursor
            # restarts at acked=-1 with the layer-aware share as its
            # total — a rank whose share is empty passes the straggler
            # test without ever sending a request, and a rank that
            # finished the horizon pre-freeze but was dealt a share of
            # the pooled remainder blocks the advance until it re-enters
            # the horizon (rank_indices is pure spec math, so calling it
            # under the lock is deadlock-free; commits are rare)
            layers = [(int(w), int(c)) for w, c in self.layers]
            for r in range(self.spec.world):
                share = int(np.asarray(self.spec.rank_indices(
                    epoch, r, layers=layers or None)).shape[0])
                if r == 0:
                    share += self._orphan_len_locked(epoch)
                lease = self._leases.get(r) or {}
                self._cursors[r] = {
                    "epoch": epoch, "acked": -1, "hi": -1, "samples": 0,
                    "batch": int(lease.get("batch") or 0),
                    "total": share,
                }
        if new_orphans:
            self.metrics.inc("orphaned", value=sum(
                int(o["hi"]) - int(o["lo"]) for o in new_orphans))
        self.metrics.inc("reshards")
        # departed ranks' per-client counters end their tenure here: a
        # rank beyond the new world, or one that left/died at this
        # barrier, is archived so the report doesn't grow forever
        for r in range(old_world):
            if (r >= self.spec.world or r in rs["leaving"]
                    or r in rs["dead"]):
                self.metrics.drop_client(r)
        t_drain = rs.get("t_drain")
        if t_drain is not None:  # absent on a restored (snapshot) barrier
            self.metrics.registry.histogram("barrier_drain_ms").observe(
                (time.perf_counter() - t_drain) * 1e3)
        telemetry.event("reshard_commit", generation=self.generation,
                        world=self.spec.world)
        # the commit record is in the WAL before any client can observe
        # the new generation (we still hold the lock), so a standby can
        # never serve gen+1 requests against pre-commit state
        self._repl_append("state", state=self._state_dict_locked())
        return True

    def _on_leave(self, sock, conn_id, header) -> None:
        """Preemption-notice drain: the rank keeps its lease, drains its
        pre-barrier allocation, then its stream ends (a terminal EOF) and
        the world shrinks by one.  ``grace_ms`` bounds the drain — past
        it the rank is declared dead and its remainder orphaned."""
        try:
            rank = int(header["rank"])
        except (KeyError, TypeError, ValueError):
            P.send_msg(sock, P.MSG_ERROR,
                       {"code": "bad_request",
                        "detail": "LEAVE needs an int rank"})
            return
        grace_ms = header.get("grace_ms")
        deadline = (None if grace_ms is None
                    else self._clock() + float(grace_ms) / 1e3)
        with self._lock:
            lease = self._leases.get(rank)
            if lease is None or lease.get("owner") != conn_id:
                P.send_msg(sock, P.MSG_ERROR, {
                    "code": "not_owner",
                    "detail": f"rank {rank} is not leased to this "
                              "connection; HELLO first",
                })
                return
            self._touch(rank, lease)
            self.metrics.inc("leaves", rank)
            world = self.spec.world
            rs = self._reshard
            if rs is not None:
                if rs.get("phase") != "drain":
                    P.send_msg(sock, P.MSG_ERROR, {
                        "code": "reshard",
                        "retry_ms":
                            self.backpressure.retry_ms("reshard_freeze"),
                        "detail": "a reshard barrier is freezing; retry",
                    })
                    return
                # join the in-flight barrier instead of compounding a
                # second one: same targets, one fewer post-reshard rank
                if rank not in rs["leaving"]:
                    rs["leaving"][rank] = deadline
                    rs["target_world"] = max(1, int(rs["target_world"]) - 1)
                P.send_msg(sock, P.MSG_OK, {
                    "reshard": True, "generation": self.generation,
                    "target_world": rs["target_world"],
                    "target_samples": rs["targets"].get(rank),
                })
                return
            if world <= 1:
                lease["owner"] = None
                P.send_msg(sock, P.MSG_OK, {
                    "reshard": False, "generation": self.generation,
                    "detail": "world is 1; nothing to reshard down to",
                })
                return
        if not self._trigger_reshard(world - 1, leaving={rank: deadline}):
            # lost a race with a concurrent trigger; the client's retry
            # joins that barrier through the branch above
            P.send_msg(sock, P.MSG_ERROR, {
                "code": "reshard",
                "retry_ms": self.backpressure.retry_ms("reshard_freeze"),
                "detail": "another reshard started concurrently; retry",
            })
            return
        with self._lock:
            rs = self._reshard
            hdr = {"reshard": True, "generation": self.generation,
                   "target_world": (rs["target_world"] if rs is not None
                                    else self.spec.world),
                   "target_samples": (rs["targets"].get(rank)
                                      if rs is not None else None)}
        P.send_msg(sock, P.MSG_OK, hdr)

    def _on_reshard(self, sock, conn_id, header) -> None:
        """Explicit world change.  One barrier at a time: a second
        request while one drains draws ``ERROR(code='reshard')`` and the
        retry layer waits the first one out."""
        try:
            new_world = int(header["world"])
        except (KeyError, TypeError, ValueError):
            P.send_msg(sock, P.MSG_ERROR,
                       {"code": "bad_request",
                        "detail": "RESHARD needs an int world"})
            return
        if new_world < 1:
            P.send_msg(sock, P.MSG_ERROR,
                       {"code": "bad_request",
                        "detail": f"world must be >= 1, got {new_world}"})
            return
        if not self._trigger_reshard(new_world):
            P.send_msg(sock, P.MSG_ERROR, {
                "code": "reshard",
                "retry_ms": self.backpressure.retry_ms("reshard_conflict"),
                "detail": "a reshard is already draining; retry",
            })
            return
        with self._lock:
            rs = self._reshard
            hdr = {"generation": self.generation, "world": self.spec.world,
                   "target_world": new_world, "committed": rs is None}
            if rs is not None:
                hdr["barrier_units"] = rs.get("barrier_units")
                hdr["epoch"] = rs.get("epoch")
        P.send_msg(sock, P.MSG_OK, hdr)

    # ---------------------------------------------------------------- HELLO
    def _on_hello(self, sock, conn_id, header) -> None:
        proto = header.get("proto")
        if proto != P.PROTOCOL_VERSION:
            # explicit version negotiation: a mismatched peer gets the
            # typed error with BOTH ints, never undefined frame decoding
            P.send_msg(sock, P.MSG_ERROR, {
                "code": "protocol_version",
                "server_proto": P.PROTOCOL_VERSION,
                "client_proto": proto,
                "detail": f"server speaks protocol {P.PROTOCOL_VERSION}, "
                          f"client sent {proto!r}",
            })
            return
        cell_refusal = self._cell_refusal(header)
        if cell_refusal is not None:
            _annotate(error_code="wrong_cell")
            P.send_msg(sock, P.MSG_ERROR, cell_refusal)
            return
        engine = self._route_hello(sock, header)
        if engine is None:
            return  # refusal already sent
        if header.get("attach"):
            # additive (docs/SHARDING.md): admit the namespace WITHOUT
            # claiming a rank lease — the shard router pre-attaches a
            # tenant on every shard that owns some of its ranks
            P.send_msg(sock, P.MSG_OK, {"tenant": engine.tenant_id})
            return
        if engine is not self:
            # bind the connection to its tenant: subsequent frames route
            # without re-stating the namespace, and the engine's sweeps
            # can close the socket it leases ranks to
            with self._lock:
                self._conn_tenant[conn_id] = engine
            with engine._lock:
                engine._conn_socks[conn_id] = sock
            _annotate(tenant=engine.tenant_id)
        engine._hello_claim(sock, conn_id, header)

    def _route_hello(self, sock, header) -> Optional["IndexServer"]:
        """Resolve a HELLO's namespace (docs/SERVICE.md "Tenancy"): no
        fingerprint or our own → the default tenant (this server), a
        known tenant fingerprint → its engine, an unknown one → admission
        (create the tenant) on a multi-tenant daemon, or the typed
        ``spec_mismatch`` refusal carrying both world-stripped
        fingerprints.  Returns the engine, or None after refusing."""
        fp = header.get("spec_fingerprint")
        ours = self.spec.fingerprint(include_world=False)
        if fp is None or fp == ours:
            return self
        eng = self._tenants.get(fp)
        if eng is not None:
            return eng
        wire = header.get("spec")
        if not self.multi_tenant or wire is None:
            detail = (
                "client and server stream specs differ; refusing to serve "
                "a different permutation than requested (this daemon is "
                "single-tenant)" if not self.multi_tenant else
                "unknown tenant fingerprint and the HELLO carried no "
                "'spec' wire form to create the tenant from"
            )
            _annotate(error_code="spec_mismatch")
            P.send_msg(sock, P.MSG_ERROR, {
                "code": "spec_mismatch",
                "server_fingerprint": ours,
                "client_fingerprint": fp,
                "detail": detail,
            })
            return None
        return self._admit_tenant(sock, fp, wire)

    def _admit_tenant(self, sock, fp, wire) -> Optional["IndexServer"]:
        """Create-or-attach for an unknown tenant fingerprint.  The
        ``tenant.admission`` fault site fires before any state changes,
        so an injected fault is a clean retryable refusal; capacity
        refusals are terminal ``spec_mismatch`` (carrying both
        fingerprints), transient ones are ``tenant_admission`` with the
        typed ``retry_ms`` backpressure."""
        try:
            F.fire("tenant.admission")
        except F.InjectedThreadDeath:
            raise
        except Exception as exc:
            self.metrics.inc("tenant_admission_rejects")
            _annotate(error_code="tenant_admission")
            P.send_msg(sock, P.MSG_ERROR, {
                "code": "tenant_admission",
                "retry_ms": self.backpressure.retry_ms("tenant_admission"),
                "detail": f"tenant admission refused ({exc!r}); retry",
            })
            return None
        try:
            spec = PartialShuffleSpec.from_wire(
                dict(wire), backend=self.spec.backend)
        except (TypeError, ValueError, KeyError) as exc:
            P.send_msg(sock, P.MSG_ERROR, {
                "code": "bad_request",
                "detail": f"HELLO 'spec' wire form did not parse: {exc!r}",
            })
            return None
        if spec.fingerprint(include_world=False) != fp:
            _annotate(error_code="spec_mismatch")
            P.send_msg(sock, P.MSG_ERROR, {
                "code": "spec_mismatch",
                "server_fingerprint": spec.fingerprint(include_world=False),
                "client_fingerprint": fp,
                "detail": "HELLO 'spec' wire form does not match the "
                          "declared fingerprint",
            })
            return None
        eng = self._make_tenant_engine(spec)
        with self._lock:
            cur = self._tenants.get(fp)
            if cur is not None:
                return cur  # concurrent creation: first registration wins
            if len(self._tenants) + 2 > self.max_tenants:
                # +2: the default tenant plus the one being created
                self.metrics.inc("tenant_admission_rejects")
                _annotate(error_code="spec_mismatch")
                P.send_msg(sock, P.MSG_ERROR, {
                    "code": "spec_mismatch",
                    "server_fingerprint":
                        self.spec.fingerprint(include_world=False),
                    "client_fingerprint": fp,
                    "tenants": len(self._tenants) + 1,
                    "max_tenants": self.max_tenants,
                    "detail": f"tenant capacity exceeded: this daemon "
                              f"serves {len(self._tenants) + 1} of "
                              f"{self.max_tenants} namespaces",
                })
                return None
            self._register_tenant_locked(fp, eng)
        self.metrics.inc("tenants_created")
        telemetry.event("tenant_created", tenant=eng.tenant_id)
        # replicate the creation with the engine's full state so a
        # standby can mirror the tenant before any of its records arrive
        self._repl_append("tenant", tenant=eng.tenant_id,
                          state=eng._state_dict())
        return eng

    def _hello_claim(self, sock, conn_id, header) -> None:
        world = header.get("world")
        if world is not None and int(world) != self.spec.world:
            P.send_msg(sock, P.MSG_ERROR, {
                "code": "world",
                "detail": f"server world is {self.spec.world}, client "
                          f"expects {world}",
            })
            return
        batch = int(header.get("batch", 0))
        if batch < 1:
            P.send_msg(sock, P.MSG_ERROR,
                       {"code": "batch", "detail": f"batch must be >= 1, "
                                                   f"got {batch}"})
            return
        want = header.get("rank", -1)
        want = -1 if want is None else int(want)
        now = self._clock()
        front = self._parent if self._parent is not None else self
        with self._lock:
            q = self.quota
            if q is not None and q.max_ranks is not None:
                live = sum(
                    1 for r, l in self._leases.items()
                    if l.get("owner") is not None
                    and l.get("owner") != conn_id
                    and now - l["last_seen"] <= self.heartbeat_timeout)
                if live >= q.max_ranks:
                    # admission control: retryable — a lease may free
                    self.metrics.inc("tenant_admission_rejects")
                    _annotate(error_code="tenant_admission")
                    P.send_msg(sock, P.MSG_ERROR, {
                        "code": "tenant_admission",
                        "retry_ms":
                            self.backpressure.retry_ms("tenant_ranks"),
                        "tenant": self.tenant_id,
                        "detail": f"tenant {self.tenant_id} holds {live} "
                                  f"live rank leases; quota max_ranks="
                                  f"{q.max_ranks}",
                    })
                    return
            if want >= self.spec.world and self.generation > 0:
                # a pre-reshard client coming back for a rank the commit
                # removed: tell it the world changed rather than "no_rank"
                P.send_msg(sock, P.MSG_ERROR, self._resharded_err_locked(
                    f"rank {want} no longer exists at world "
                    f"{self.spec.world}; rejoin with rank=-1"))
                return
            rank = self._claim_rank_locked(want, conn_id, now)
            if rank is None:
                code = "rank_taken" if 0 <= want < self.spec.world \
                    else "no_rank"
                P.send_msg(sock, P.MSG_ERROR, {
                    "code": code,
                    "detail": f"rank {want} is live-leased" if code ==
                              "rank_taken" else
                              f"all {self.spec.world} ranks are live-leased",
                })
                return
            self._leases[rank]["batch"] = batch
            self._repl_append("lease", rank=rank, batch=batch)
            if rank in self._cursors:
                self.metrics.inc("reconnects", rank)
            welcome = {
                "proto": P.PROTOCOL_VERSION,
                "rank": rank,
                "spec": self.spec.to_wire(),
                # term/standby are front-server facts: a tenant's client
                # fails over to the DAEMON's standby, which mirrors every
                # tenant (additive field, like ``trace``)
                "tenant": self.tenant_id,
                "term": int(front.term),
                "standby": (list(front._standby_addr)
                            if front._standby_addr is not None else None),
                # additive: the pipelined client bounds its lookahead by
                # the server's throttle window (docs/SERVICE.md)
                "max_inflight": int(self.max_inflight),
                **self._membership_locked(),
                # additive: shard servers ride their rank→shard map here
                # (docs/SHARDING.md); empty for a standalone daemon
                **self._welcome_extra(),
                # additive: the serving cell + global directory on a
                # federated deployment (docs/FEDERATION.md); empty
                # otherwise — front-server facts, like term/standby
                **front._cell_fields(),
                # additive: the autopilot's batch-size suggestion; the
                # field does not exist until a controller has tuned it
                # (docs/AUTOPILOT.md)
                **({"batch_hint": int(self._batch_hint)}
                   if self._advertise_knobs and self._batch_hint is not None
                   else {}),
            }
        self._write_snapshot()
        P.send_msg(sock, P.MSG_WELCOME, welcome)

    def _welcome_extra(self) -> dict:
        """Extra additive WELCOME fields; ``ShardServer`` overrides to
        attach its ``shard_map`` + ``shard`` id (docs/SHARDING.md)."""
        return {}

    # ------------------------------------------------------------ autopilot
    def set_autopilot_knobs(self, *, max_inflight=None,
                            batch_hint=None) -> None:
        """Adopt controller-tuned serving knobs (autopilot/controller.py).

        The first call flips ``_advertise_knobs``: WELCOME gains the
        additive ``batch_hint`` field and heartbeat replies gain
        ``knobs`` — before it, neither exists on the wire, which is the
        zero-protocol-bytes-while-disabled rail (docs/AUTOPILOT.md).
        The knob values themselves ride the controller's ``autopilot``
        WAL record, not this call, so mirrors adopt them there."""
        with self._lock:
            if max_inflight is not None:
                self.max_inflight = max(1, int(max_inflight))
            if batch_hint is not None:
                self._batch_hint = max(1, int(batch_hint))
            self._advertise_knobs = True

    def autopilot_state(self) -> Optional[dict]:
        """The newest controller policy state replicated to this server
        (the ``autopilot`` WAL record's ``pstate``).  A promoted standby
        hands it to its own controller so decisions RESUME from the old
        primary's trajectory instead of restarting cold."""
        with self._lock:
            st = self._autopilot_state
            return dict(st) if st is not None else None

    def _knob_fields(self) -> dict:
        """Additive knob advertisement for heartbeat replies; empty
        until ``set_autopilot_knobs`` has ever run."""
        if not self._advertise_knobs:
            return {}
        kn = {"max_inflight": int(self.max_inflight)}
        if self._batch_hint is not None:
            kn["batch_hint"] = int(self._batch_hint)
        return kn

    def _claim_rank_locked(self, want: int, conn_id: int, now: float):
        """Grant ``want`` (or the lowest free rank for -1).  Called under
        ``self._lock``.  A stale live lease is evicted on the spot."""
        candidates = ([want] if want >= 0 else range(self.spec.world))
        fresh = want < 0 and self.generation > 0
        for rank in candidates:
            if not 0 <= rank < self.spec.world:
                return None
            lease = self._leases.get(rank)
            if lease is not None and lease.get("owner") is not None:
                if now - lease["last_seen"] <= self.heartbeat_timeout:
                    continue  # genuinely live
                lease["owner"] = None
                self.metrics.inc("evictions", rank)
                self.metrics.drop_client(rank)
            if fresh:
                cur = self._cursors.get(rank)
                if cur is not None and int(cur.get("samples", 0)) > 0:
                    # post-reshard auto-claims start at seq 0, so a slot
                    # whose current-generation stream is already partly
                    # served (its previous owner completed or died after
                    # pulling batches) would be double-delivered — only
                    # unserved slots (a leaver's freed lease, a grown
                    # world's new ranks) are adoptable fresh
                    continue
            self._leases[rank] = {"owner": conn_id, "last_seen": now,
                                  "batch": self._leases.get(rank, {}).get(
                                      "batch", 0)}
            self._vacated.pop(rank, None)
            return rank
        return None

    # ------------------------------------------------------------ GET_BATCH
    def _on_get_batch(self, sock, conn_id, header) -> None:
        try:
            rank = int(header["rank"])
            epoch = int(header["epoch"])
            seq = int(header["seq"])
        except (KeyError, TypeError, ValueError):
            P.send_msg(sock, P.MSG_ERROR,
                       {"code": "bad_request",
                        "detail": "GET_BATCH needs rank/epoch/seq ints"})
            return
        if seq < 0:
            P.send_msg(sock, P.MSG_ERROR,
                       {"code": "bad_request", "detail": f"seq {seq} < 0"})
            return
        # a piggybacked previous-epoch terminal ack lands BEFORE the
        # request's own generation/epoch logic: if it completes a drain
        # (bumping the generation), this very request is then refused
        # with the fresh membership — exactly what its sender must adopt
        self._apply_piggyback_ack(conn_id, rank, header.get("hb"))
        gen = int(header.get("gen", 0))
        t_req = time.perf_counter()
        advanced = False
        with self._lock:
            if gen != self.generation:
                # the request names a stream of a committed-away
                # generation: hand the client the membership to adopt
                _annotate(error_code="resharded")
                P.send_msg(sock, P.MSG_ERROR, self._resharded_err_locked(
                    f"generation {gen} was resharded away (now at "
                    f"{self.generation})"))
                return
            rs = self._reshard
            if rs is not None and rs.get("phase") == "freeze":
                _annotate(error_code="reshard")
                P.send_msg(sock, P.MSG_ERROR, {
                    "code": "reshard",
                    "retry_ms":
                        self.backpressure.retry_ms("reshard_freeze"),
                    "detail": "reshard barrier is freezing; retry shortly",
                })
                return
            lease = self._leases.get(rank)
            if lease is None or lease.get("owner") != conn_id:
                P.send_msg(sock, P.MSG_ERROR, {
                    "code": "not_owner",
                    "detail": f"rank {rank} is not leased to this "
                              "connection; HELLO first",
                })
                return
            self._touch(rank, lease)
            if self.streaming:
                # eligibility + ack-gated advance, BEFORE the cursor
                # reset below (docs/STREAMING.md): a refused request
                # must leave every rank's horizon cursor intact so the
                # barrier's straggler test stays truthful
                refusal, advanced = self._stream_gate_locked(epoch)
                if refusal is not None:
                    P.send_msg(sock, P.MSG_ERROR, refusal)
                    return
            batch = lease["batch"]
            cur = self._cursors.get(rank)
            if cur is None or cur["epoch"] != epoch:
                cur = self._cursors[rank] = {"epoch": epoch, "acked": -1,
                                             "hi": -1, "samples": 0}
            if self.streaming:
                # the advance barrier converts acked seqs to samples
                # with this batch; keeping it on the cursor preserves
                # the conversion after the lease is gone (a finished
                # rank that disconnected before the advance), and
                # refreshing it heals a commit-re-pinned cursor created
                # before this rank held a lease
                cur["batch"] = int(batch)
            ack = header.get("ack")
            acked_advanced = False
            if ack is not None and int(ack) > cur["acked"]:
                cur["acked"] = int(ack)
                acked_advanced = True
            if seq > cur["acked"] + self.max_inflight:
                self.metrics.inc("throttled", rank)
                _annotate(error_code="throttle")
                P.send_msg(sock, P.MSG_ERROR, {
                    "code": "throttle",
                    "detail": f"seq {seq} is {seq - cur['acked']} past the "
                              f"acked cursor; max_inflight="
                              f"{self.max_inflight}",
                    "retry_ms": self.backpressure.retry_ms("throttle"),
                })
                return
            clamp = None
            reply = None
            committed = False
            if (rs is not None and rs.get("phase") == "drain"
                    and epoch == rs["epoch"] and rank in rs["targets"]):
                t = int(rs["targets"][rank])
                if seq * batch >= t:
                    if (cur["acked"] + 1) * batch < t:
                        # past the target, but delivery of the pre-barrier
                        # tail is not acked — a served-but-lost final
                        # reply must stay resendable, so the drain
                        # completes only on the client's ack
                        reply = (P.MSG_ERROR, {
                            "code": "reshard",
                            "retry_ms":
                                self.backpressure.retry_ms("reshard_freeze"),
                            "detail": f"rank {rank} reached its barrier "
                                      "target without acking the full "
                                      "pre-barrier span; retry",
                        }, b"")
                    else:
                        # the rank ACKED its full pre-barrier allocation
                        rs["drained"].add(rank)
                        leaving = rank in rs["leaving"]
                        try:
                            committed = self._commit_reshard_locked()
                        except F.InjectedThreadDeath:
                            raise
                        except Exception:  # lint: allow-broad-except(injected commit fault; retried)
                            pass
                        if not committed:
                            self._repl_append(
                                "state",
                                state=self._state_dict_locked())
                        if leaving:
                            # terminal EOF: the leaving stream ends
                            reply = (P.MSG_BATCH,
                                     {"seq": seq, "eof": True, "total": t,
                                      "end": t, "left": True}, b"")
                        elif gen != self.generation:
                            reply = (P.MSG_ERROR,
                                     self._resharded_err_locked(
                                         "reshard committed; adopt the "
                                         "new membership"), b"")
                        else:
                            reply = (P.MSG_ERROR, {
                                "code": "reshard",
                                "retry_ms": self.backpressure.retry_ms(
                                    "reshard_freeze"),
                                "detail": f"rank {rank} drained to its "
                                          "barrier target; waiting for "
                                          "the commit",
                            }, b"")
                else:
                    clamp = t
            resend = seq <= cur["hi"]
        if advanced:
            # the horizon advance this request committed seals a forced
            # checkpoint (outside the lock — the writer retakes it) so
            # the WAL truncates below the new watermark
            self._stream_advanced(t_req)
        if reply is not None:
            if committed:
                self._write_snapshot(force=True)
            mt, h, pl = reply
            P.send_msg(sock, mt, h, pl)
            return
        arr = self._rank_array(epoch, rank)
        lo = seq * batch
        total = int(arr.shape[0])
        limit = total if clamp is None else min(clamp, total)
        if lo >= limit:
            if acked_advanced or (self.streaming and clamp is None):
                # the epoch's terminal ack rides the EOF poll and no
                # slice is served below, so the usual served-slice
                # cursor append never runs — persist the advance here
                # or recovery resumes one ack behind
                with self._lock:
                    cur = self._cursors.get(rank)
                    if cur is not None and cur["epoch"] == epoch:
                        if self.streaming and clamp is None:
                            # the horizon's layer-aware end — what the
                            # advance barrier's straggler test compares
                            # acked delivery against; MUST come from
                            # _rank_array (a mid-horizon reshard shrinks
                            # remainder allocations below num_samples)
                            cur["total"] = int(total)
                        if acked_advanced:
                            self._repl_append("cursor", rank=rank, **cur)
            P.send_msg(sock, P.MSG_BATCH,
                       {"seq": seq, "eof": True, "total": total,
                        "end": limit, "gen": gen})
            return
        sl = arr[lo:min(lo + batch, limit)]
        end = lo + int(sl.shape[0])
        fields, payload = P.encode_indices(sl)
        with self._lock:
            stale = None
            rs = self._reshard
            if gen != self.generation:
                # a concurrent sweep committed while we were encoding —
                # serving old-generation bytes now could duplicate an
                # orphaned span, so refuse and hand over the membership
                stale = self._resharded_err_locked(
                    "reshard committed mid-request; adopt the new "
                    "membership")
            elif rs is not None and rs.get("phase") == "freeze":
                # a barrier froze while we were generating/encoding:
                # delivering now would outrun the watermark snapshot the
                # freeze took (the span would also ride the repartitioned
                # remainder, i.e. be served twice) — refuse; the retry is
                # served clamped once the drain opens
                stale = {"code": "reshard",
                         "retry_ms":
                             self.backpressure.retry_ms("reshard_freeze"),
                         "detail": "reshard barrier froze mid-request; "
                                   "retry shortly"}
            elif (rs is not None and rs.get("phase") == "drain"
                    and epoch == rs["epoch"] and rank in rs["targets"]
                    and clamp is None and end > int(rs["targets"][rank])):
                # same race, one tick later: the barrier froze AND opened
                # its drain mid-request, and this unclamped slice overruns
                # the rank's drain target — refuse rather than duplicate
                stale = {"code": "reshard",
                         "retry_ms":
                             self.backpressure.retry_ms("reshard_freeze"),
                         "detail": "reshard barrier cut below this batch "
                                   "mid-request; retry shortly"}
            else:
                cur = self._cursors.get(rank)
                if cur is not None and cur["epoch"] == epoch:
                    cur["hi"] = max(cur["hi"], seq)
                    cur["samples"] = max(int(cur.get("samples", 0)), end)
                    if self.streaming and clamp is None and end >= limit:
                        # last slice of the horizon: pin the layer-aware
                        # end on the cursor so the terminal ack (which
                        # may arrive piggybacked, with no further
                        # GET_BATCH for this horizon) satisfies the
                        # advance barrier — and replicates with it
                        cur["total"] = int(limit)
                    self._repl_append("cursor", rank=rank, **cur)
        if stale is not None:
            P.send_msg(sock, P.MSG_ERROR, stale)
            return
        self.metrics.inc("batches_served", rank)
        if resend:
            self.metrics.inc("resends", rank)
        self._write_snapshot()
        P.send_msg(sock, P.MSG_BATCH,
                   {"seq": seq, "eof": False, "total": total, "end": end,
                    "gen": gen, **fields},
                   payload)

    # ---------------------------------------- moving-horizon streaming
    def _on_append(self, sock, header) -> None:
        """A feeder extends the append-only index space
        (docs/STREAMING.md).  Exactly-once under retries rests on two
        invariants, never on any single WAL append landing: the appended
        total is ABSOLUTE in every ``stream`` record (replay takes the
        max), and ``stream_seq`` is monotonic per feeder id, so a
        retried APPEND whose first attempt half-landed is recognized and
        answered with the current totals instead of re-applied."""
        if not self.streaming:
            P.send_msg(sock, P.MSG_ERROR, {
                "code": "bad_request",
                "detail": "APPEND against a non-stream spec; only "
                          "mode='stream' index spaces grow",
            })
            return
        try:
            count = int(header["count"])
            seq = int(header.get("stream_seq", 0))
            feeder = str(header.get("feeder", ""))
        except (KeyError, TypeError, ValueError):
            P.send_msg(sock, P.MSG_ERROR, {
                "code": "bad_request",
                "detail": "APPEND needs an int count",
            })
            return
        if count < 0:
            P.send_msg(sock, P.MSG_ERROR, {
                "code": "bad_request", "detail": f"count {count} < 0"})
            return
        try:
            F.fire("stream.append")
        except F.InjectedThreadDeath:
            raise
        except Exception as exc:
            # the site fires BEFORE any mutation: an injected append
            # fault is a clean retryable refusal, and the feeder's
            # stream_seq makes the retry exactly-once
            _annotate(error_code="stream_append")
            P.send_msg(sock, P.MSG_ERROR, {
                "code": "stream_append",
                "retry_ms": self.backpressure.retry_ms("stream_append"),
                "detail": f"append refused ({exc!r}); retry",
            })
            return
        delta = header.get("weights_delta")
        h = int(self.spec.horizon)
        with self._lock:
            if self._stream_seqs.get(feeder, -1) >= seq:
                # a retry of an APPEND that already landed: answer with
                # the current totals, mutate nothing
                P.send_msg(sock, P.MSG_OK, {
                    "appended": int(self._stream_appended),
                    "eligible": int(self.spec.eligible_horizons(
                        self._stream_appended)),
                    "epoch": int(self.epoch), "stream_seq": seq,
                    "duplicate": True,
                })
                return
            before = self._stream_appended
            self._stream_appended = before + count
            self._stream_seqs[feeder] = seq
            if delta is not None:
                cur = self._stream_pending
                self._stream_pending = (
                    [int(x) for x in delta] if cur is None
                    else [int(a) + int(b) for a, b in zip(cur, delta)])
            now = time.perf_counter()
            self._stream_first_t.setdefault(before // h, now)
            for g in range(before // h, self._stream_appended // h):
                # horizon g just completed — appended → servable
                t_open = self._stream_first_t.pop(g, now)
                self.metrics.registry.histogram(
                    "append_visible_ms").observe((now - t_open) * 1e3)
            self._repl_append(
                "stream", appended=int(self._stream_appended),
                seqs={str(k): int(v)
                      for k, v in self._stream_seqs.items()},
                pending=(list(self._stream_pending)
                         if self._stream_pending is not None else None))
            appended = self._stream_appended
            eligible = self.spec.eligible_horizons(appended)
            epoch = self.epoch
        self.metrics.inc("stream_appends")
        self._write_snapshot()
        P.send_msg(sock, P.MSG_OK, {
            "appended": int(appended), "eligible": int(eligible),
            "epoch": int(epoch), "stream_seq": seq,
        })

    def _stream_stragglers_locked(self, g: int) -> list[int]:
        """Ranks that have not ACKED their full horizon-``g`` allocation
        — the advance barrier's completion test.  The per-rank target is
        the ``total`` the serve path pinned on the rank's cursor (the
        layer-aware end of its stream: a mid-horizon reshard shrinks
        remainder allocations below ``spec.num_samples``, so the base
        spec alone would deadlock the barrier).  A rank with no cursor
        at all is excused only when its base allocation is zero; the
        ack→samples conversion batch comes from the cursor so a finished
        rank that already dropped its lease still passes.  Under
        ``self._lock``."""
        out = []
        for r in range(self.spec.world):
            cur = self._cursors.get(r)
            if cur is None:
                if int(self.spec.num_samples(r) or 0) > 0:
                    out.append(r)
                continue
            total = cur.get("total")
            if (int(cur["epoch"]) == int(g) and total is not None
                    and int(total) <= 0):
                # an empty allocation (e.g. a re-pinned zero remainder
                # share after a reshard) is complete by definition — no
                # request, lease or batch required
                continue
            b = int(cur.get("batch")
                    or self._leases.get(r, {}).get("batch") or 0)
            if (int(cur["epoch"]) != int(g) or total is None or b <= 0
                    or (int(cur["acked"]) + 1) * b < int(total)):
                out.append(r)
        return out

    def _stream_gate_locked(self, epoch: int):
        """The eligibility + ack-gated advance gate on a streaming
        request naming horizon ``epoch`` (docs/STREAMING.md).  Returns
        ``(refusal, advanced)``: a typed ERROR header to refuse with (or
        None to serve), and whether this request committed a horizon
        advance — the caller then runs :meth:`_stream_advanced` outside
        the lock.  Under ``self._lock``."""
        epoch = int(epoch)
        eligible = self.spec.eligible_horizons(self._stream_appended)
        if epoch >= eligible:
            # eligibility law: horizon g needs (g+1)*H appended samples
            # — whole horizons only, so the permutation input is always
            # the full block and the stream stays pure
            _annotate(error_code="horizon_pending")
            return ({
                "code": "horizon_pending",
                "retry_ms": self.backpressure.retry_ms("horizon_gate"),
                "appended": int(self._stream_appended),
                "eligible": int(eligible),
                "detail": f"horizon {epoch} is not fully appended "
                          f"({self._stream_appended} samples, "
                          f"{eligible} eligible horizons)",
            }, False)
        if epoch <= self.epoch:
            # the current horizon, or an earlier one — both pure
            # regenerable; resends below the watermark serve unchanged
            return None, False
        if epoch > self.epoch + 1:
            _annotate(error_code="horizon_advance")
            return ({
                "code": "horizon_advance",
                "retry_ms": self.backpressure.retry_ms("horizon_gate"),
                "epoch": int(self.epoch),
                "detail": f"horizon {epoch} is {epoch - self.epoch} "
                          f"ahead of the stream (at {self.epoch}); "
                          "advance is one horizon at a time",
            }, False)
        stragglers = self._stream_stragglers_locked(self.epoch)
        if stragglers:
            _annotate(error_code="horizon_advance")
            return ({
                "code": "horizon_advance",
                "retry_ms": self.backpressure.retry_ms("horizon_gate"),
                "epoch": int(self.epoch),
                "detail": f"ranks {stragglers} have not acked their "
                          f"full horizon-{self.epoch} allocation",
            }, False)
        try:
            F.fire("stream.advance")
        except F.InjectedThreadDeath:
            raise
        except Exception as exc:
            # the site fires BEFORE any mutation, so an injected abort
            # rolls back to exactly the pre-advance state
            _annotate(error_code="horizon_advance")
            return ({
                "code": "horizon_advance",
                "retry_ms": self.backpressure.retry_ms("horizon_gate"),
                "epoch": int(self.epoch),
                "detail": f"advance aborted ({exc!r}); retry",
            }, False)
        self._stream_advance_locked(epoch)
        return None, True

    def _stream_advance_locked(self, new_epoch: int) -> None:
        """Commit the horizon advance (caller already passed the
        straggler + eligibility gates): fold the pending weights delta
        into the spec's per-horizon weights, bump the horizon
        generation, and log the absolute stream state.  Under
        ``self._lock``."""
        from ..streaming.spec import WEIGHTS_RETAIN

        weights = None
        if self._stream_pending is not None:
            prev = self.spec.weights_for(self.epoch)
            if prev is not None:
                # additive deltas on top of the previous horizon's
                # effective weights, floored at 1 (mixture weights are
                # integer quotas — ops/mixture.py)
                weights = tuple(
                    max(1, int(a) + int(b))
                    for a, b in zip(prev, self._stream_pending))
                self.spec = self.spec.with_stream_weights(
                    {int(new_epoch): weights},
                    prune_below=int(new_epoch) - WEIGHTS_RETAIN // 2)
            self._stream_pending = None
        self.epoch = int(new_epoch)
        self._repl_append(
            "stream", appended=int(self._stream_appended),
            epoch=int(self.epoch),
            weights=(list(weights) if weights is not None else None))
        telemetry.event("horizon_advance", epoch=int(self.epoch))

    def _stream_advanced(self, t0: float) -> None:
        """Post-advance persistence, OUTSIDE ``self._lock`` (the
        snapshot writer retakes it): seal a forced checkpoint so the WAL
        GC truncates every record below the new horizon's watermark —
        server + WAL state stays O(horizon), not O(stream)
        (docs/STREAMING.md "Bounded state")."""
        wal = self._wal
        before = len(wal.segment_paths()) if wal is not None else 0
        self._write_snapshot(force=True)
        if wal is not None:
            dropped = before - len(wal.segment_paths())
            if dropped > 0:
                self.metrics.inc("stream_gc_truncations", value=dropped)
        self.metrics.inc("horizon_advances")
        self.metrics.registry.histogram("horizon_advance_ms").observe(
            (time.perf_counter() - t0) * 1e3)
