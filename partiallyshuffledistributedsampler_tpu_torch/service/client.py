"""`ServiceIndexClient`: the consumer side of the index service.

A copy of the JAX package's ``service/client.py``, byte-compatible on the
wire with its servers.  The capability path and the degraded fallback
regenerate through the handed spec's backend (on ``"cuda"`` the kernels,
one readback).

A thin, synchronous client that claims a rank, streams its epoch's index
batches, and survives server restarts: every request is idempotent (the
server is a pure function of ``(epoch, seq)`` plus the spec), so the
retry layer reconnects with exponential backoff + jitter and replays the
cursor — the delivered index stream is exactly-once and bit-identical to
a local sampler run no matter how many times the connection (or the
server) died in between.

Drop-in surfaces:

* ``epoch_indices(epoch)`` → the rank's full epoch stream as one host
  array — feed it anywhere a local ``epoch_indices`` result goes
  (``HostDataLoader(..., index_client=client)`` does exactly this).
* ``epoch_batches(epoch)`` → an iterator of index batches, resumable via
  ``start_seq`` / ``state_dict()``; wrap it in
  :class:`~..utils.stall_probe.StallProbe` to measure service-path
  starvation the same way the local loaders are measured.

Elastic membership (docs/RESILIENCE.md "Elastic membership"): the client
stamps every ``GET_BATCH`` with the server generation it believes in;
when a reshard commits underneath it, the server's typed ``resharded``
error carries the new membership (generation, world, §6 cascade layers,
orphan descriptors) and the stream *rides through*: the generator adopts
it, renegotiates a rank if its old one no longer exists, and continues
yielding the post-reshard remainder — the consumer sees one contiguous,
exactly-once stream across the world change.  ``leave(grace_ms)`` is the
preemption-notice drain (hook it to SIGTERM); while a barrier drains,
requests wait it out through the retry policy and surface a typed
:class:`ReshardInProgress` only when the deadline is exhausted.

Hot-standby failover (docs/RESILIENCE.md "Replication & failover"): the
WELCOME header carries the standby's address when the server ships its
WAL to one.  When the primary's retry budget exhausts, the client fails
over — re-HELLO to the standby with ``failover=true`` (which promotes it
once its replication feed is stale) under a FRESH retry deadline and
budget, then replays its delivered-ack cursor; the ack machinery
makes the resumed stream exactly-once and bit-identical.  The client
adopts the fencing ``term`` from every WELCOME and stamps it on requests
after a failover; a fenced zombie primary's typed ``fenced`` refusal
(``serving=false``) routes the client to the winner, surfacing
:class:`FencedError` only when no peer at the winning term is
reachable.  A client pointed at a standby of a *healthy* pair follows
the ``standby`` error's ``primary`` redirect instead.

Multi-tenancy (docs/SERVICE.md "Tenancy"): when constructed with
``spec=``, HELLO carries the full wire spec alongside the world-stripped
fingerprint, so a multi-tenant daemon can *create* the job's namespace
on first contact instead of refusing the mismatch.  The WELCOME's
``tenant`` id is adopted and stamped on every subsequent request (so a
reconnect or failover lands back in the same namespace), a refused
attach surfaces as the typed :class:`SpecMismatchError` carrying both
fingerprints, and a ``tenant_admission`` refusal (per-tenant quota) is
retried like throttle backpressure using the server's ``retry_ms``.

Capability mode (docs/CAPABILITY.md "Serve seeds, not indices"): when
both sides share a ``capability_secret``, ``capability_epoch_batches``
streams the epoch with ZERO index bytes on the wire — the client fetches
one signed :class:`~..capability.EpochCapability`, verifies it
(signature, fingerprint, tenant, generation, epoch), regenerates its
stream on-device with the same kernels the degraded fallback uses, and
reports only ack watermarks over periodic heartbeats.  Exactly-once
cursors, elastic drain barriers, and failover replay all keep working
because issuance creates the rank's epoch cursor server-side and the
heartbeat acks drive it exactly as batch requests would.
"""

from __future__ import annotations

import os
import socket
import threading
import time
from collections import deque
from typing import Iterator, Optional

import numpy as np

from .. import faults as F
from ..capability import (
    CapabilityError,
    EpochCapability,
    membership_stream,
    orphan_slice,
    replay_trail,
)
from ..telemetry import enabled as _tel_enabled, span as _span
from ..tenancy import tenant_id_for
from ..utils.retry import RetryPolicy
from . import protocol as P
from .metrics import ServiceMetrics

#: ERROR codes that indicate a configuration/contract problem — retrying
#: cannot fix them, so they raise immediately
_FATAL_CODES = frozenset(
    {"proto", "protocol_version", "world", "spec", "spec_mismatch", "batch",
     "bad_request", "unknown_type", "protocol", "no_rank"}
)

#: consecutive checksum rejects on one seq before the client gives up on
#: re-requesting (a link that corrupts every replay is not transient)
_MAX_CHECKSUM_REJECTS = 4

#: process-wide feeder-id allocator for APPEND exactly-once dedup
_FEEDER_LOCK = threading.Lock()
_FEEDER_SEQ = 0


class ServiceError(RuntimeError):
    """Server answered ERROR; ``code`` carries the protocol error code
    and ``header`` the full reply header (membership fields ride there
    on ``resharded`` errors)."""

    def __init__(self, code: str, detail: str = "",
                 header: Optional[dict] = None) -> None:
        super().__init__(f"[{code}] {detail}" if detail else code)
        self.code = code
        self.header = header if header is not None else {}


class ServiceUnavailable(ServiceError):
    """Retries exhausted without reaching a serving daemon."""

    def __init__(self, detail: str) -> None:
        super().__init__("unavailable", detail)


class ReshardInProgress(ServiceError):
    """A reshard barrier kept the server draining past the operation's
    retry deadline.  The stream is intact — retrying the same operation
    after the barrier commits continues it exactly-once."""

    def __init__(self, detail: str) -> None:
        super().__init__("reshard", detail)


class SpecMismatchError(ServiceError):
    """The server's world-stripped spec fingerprint does not match ours
    and it refused to (or could not) attach a tenant for it — a
    single-tenant daemon serving a different job, a mis-declared
    fingerprint, or a multi-tenant daemon at its ``max_tenants``
    capacity.  Carries both fingerprints so the operator can see *which*
    config each side holds."""

    def __init__(self, detail: str = "", header: Optional[dict] = None) -> None:
        super().__init__("spec_mismatch", detail, header)
        hdr = self.header
        self.server_fingerprint = hdr.get("server_fingerprint")
        self.client_fingerprint = hdr.get("client_fingerprint")


class FencedError(ServiceError):
    """Every reachable peer refused the request as fenced: a promotion
    to ``term`` superseded the server(s) this client can reach, and no
    peer serving at that term is attached.  The stream is intact — a
    retry once the new primary is reachable (or the degraded local
    fallback) continues it exactly-once."""

    def __init__(self, term: int, detail: str = "",
                 header: Optional[dict] = None) -> None:
        super().__init__("fenced", detail, header)
        self.term = int(term)


def _typed_error(code: str, detail: str, header: dict) -> ServiceError:
    """Build the most specific exception type for a server ERROR code."""
    if code == "spec_mismatch":
        return SpecMismatchError(detail, header)
    return ServiceError(code, detail, header)


def _parse_address(address):
    if isinstance(address, (tuple, list)):
        host, port = address
        return str(host), int(port)
    host, _, port = str(address).rpartition(":")
    return host or "127.0.0.1", int(port)


class ServiceIndexClient:
    """One rank's view of an :class:`~.server.IndexServer`.

    address:     ``(host, port)`` or ``"host:port"``.
    rank:        the rank to claim; ``None`` auto-claims the lowest free
                 rank (the server assigns; read ``client.rank`` after).
    batch:       transport batch size (indices per GET_BATCH) — a wire
                 chunking knob, independent of the training batch size.
    spec:        optional :class:`~.spec.PartialShuffleSpec`; when given,
                 HELLO carries its fingerprint and the server refuses a
                 mismatch (otherwise the client trusts the server and
                 exposes the served config as ``client.spec_wire``).
    timeout:     per-request socket timeout (seconds).
    reconnect_timeout: total time the retry layer keeps trying to reach a
                 server before raising :class:`ServiceUnavailable`.
    backoff_base/backoff_max: exponential-backoff bounds, consumed by the
                 default :class:`~..utils.retry.RetryPolicy` (full
                 jitter, so N clients dropped by one restart don't
                 reconnect in lockstep).
    retry_policy: a :class:`~..utils.retry.RetryPolicy` overriding the
                 one built from the three knobs above; carries the
                 circuit breaker that makes a dead daemon fail fast
                 between operations instead of paying the full deadline
                 on every call.
    lookahead:   how many GET_BATCH requests ``epoch_batches`` keeps in
                 flight on a healthy connection (docs/SERVICE.md
                 "Serve-path fusion").  The effective window is clamped
                 by the server's WELCOME-advertised ``max_inflight`` so
                 pipelining never trips the throttle gate; ``1``
                 restores the strictly request-reply serve path.
    capability_secret: per-deployment HMAC key for verifying signed
                 epoch capabilities (docs/CAPABILITY.md); ``None``
                 disables ``capability_epoch_batches``.
    capability_heartbeat_s: keepalive cadence for capability-mode
                 (batchless) streams — a HEARTBEAT carrying the
                 delivered-ack cursor goes out at least this often, so
                 lease eviction and lazy drain commits behave
                 identically with and without batch flow.
    clock:       injectable monotonic clock for that cadence (tests).
    cell_directory: optional seed for the federation's tenant → cell
                 namespace (a ``CellDirectory``, or its wire dict); the
                 live one is adopted from WELCOMEs and ``wrong_cell``
                 refusals, version-gated (docs/FEDERATION.md).
    """

    def __init__(
        self,
        address,
        *,
        rank: Optional[int] = None,
        batch: int = 65536,
        spec=None,
        timeout: float = 10.0,
        reconnect_timeout: float = 30.0,
        backoff_base: float = 0.05,
        backoff_max: float = 2.0,
        metrics: Optional[ServiceMetrics] = None,
        retry_policy: Optional[RetryPolicy] = None,
        lookahead: int = 4,
        capability_secret=None,
        capability_heartbeat_s: float = 1.0,
        clock=None,
        attach: bool = False,
        auto_batch: bool = False,
        cell_directory=None,
    ) -> None:
        self.address = _parse_address(address)
        self.rank = None if rank is None else int(rank)
        self.batch = int(batch)
        if self.batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        self.expected_spec = spec
        self.timeout = float(timeout)
        self.reconnect_timeout = float(reconnect_timeout)
        self.backoff_base = float(backoff_base)
        self.backoff_max = float(backoff_max)
        self.retry_policy = retry_policy if retry_policy is not None \
            else RetryPolicy(
                base=self.backoff_base, max_delay=self.backoff_max,
                deadline=self.reconnect_timeout,
                # open only after enough consecutive failures to have
                # exhausted a typical _rpc deadline, and re-probe quickly:
                # the breaker exists to fail FAST between operations, not
                # to delay recovery
                breaker_threshold=12, breaker_reset=1.0,
            )
        self.metrics = metrics if metrics is not None else ServiceMetrics()
        self.lookahead = int(lookahead)
        if self.lookahead < 1:
            raise ValueError(f"lookahead must be >= 1, got {lookahead}")
        #: opt in to the server's autopilot batch suggestion: a WELCOME
        #: ``batch_hint`` (or a heartbeat ``knobs`` field) is adopted at
        #: the next epoch boundary (docs/AUTOPILOT.md)
        self.auto_batch = bool(auto_batch)
        self._batch_hint: Optional[int] = None
        #: per-deployment HMAC key for verifying signed epoch
        #: capabilities (docs/CAPABILITY.md); None disables the
        #: capability-mode stream entirely
        self.capability_secret = capability_secret
        self.capability_heartbeat_s = float(capability_heartbeat_s)
        self._clock = clock if clock is not None else time.monotonic
        #: the latest HEARTBEAT/CAPABILITY reply's drain notice for this
        #: capability-mode rank: ``{"epoch", "target_samples"}`` while a
        #: barrier drains, else None (docs/CAPABILITY.md "Drain law")
        self._cap_drain: Optional[dict] = None
        #: resume point from the latest grant: the slot's server-side
        #: acked cursor + 1, in seq units — a takeover of a partly-
        #: served slot regenerates from here, never from seq 0
        self._cap_resume_seq = 0
        #: the server's throttle window, adopted from WELCOME (additive
        #: field); bounds the pipelined lookahead so a full window of
        #: un-acked requests is never refused as out-of-window
        self._server_max_inflight: Optional[int] = None
        #: learned cap after a throttle refusal mid-pipeline (an old
        #: server that does not advertise ``max_inflight``)
        self._pipe_cap: Optional[int] = None
        #: a deferred delivered-ack cursor ``[epoch, ack]`` — the
        #: previous epoch's terminal ack, piggybacked (header field
        #: ``hb``) on the next GET_BATCH/HEARTBEAT instead of costing a
        #: dedicated EOF poll; re-application is idempotent server-side
        self._pending_hb: Optional[list] = None
        #: namespace id adopted from WELCOME (docs/SERVICE.md "Tenancy");
        #: stamped on every request so a re-dial of a multi-tenant daemon
        #: lands back in the same tenant even before the re-HELLO binds us
        self.tenant: Optional[str] = None
        #: the deployment's rank→shard map (raw wire dict), adopted from
        #: a router WELCOME or a ``wrong_shard`` refusal; ``None`` on an
        #: unsharded deployment (docs/SHARDING.md)
        self.shard_map: Optional[dict] = None
        #: where the router listens, remembered at the first router
        #: WELCOME — the fallback re-route target when an adopted map
        #: carries no address for our shard
        self._router_address: Optional[tuple] = None
        #: the federation's cell directory (raw wire dict), seeded from
        #: the ctor and refreshed by WELCOME / ``wrong_cell`` refusals;
        #: ``None`` on an unfederated deployment (docs/FEDERATION.md)
        self.cell_directory: Optional[dict] = (
            None if cell_directory is None
            else (cell_directory.to_wire()
                  if hasattr(cell_directory, "to_wire")
                  else dict(cell_directory)))
        #: which cell the current connection serves in, from WELCOME
        self.cell: Optional[str] = None
        self.spec_wire: Optional[dict] = None
        self.server_epoch: Optional[int] = None
        self._sock: Optional[socket.socket] = None
        self._cursor = {"epoch": None, "seq": 0}  # next undelivered batch
        # -------- elastic membership (docs/RESILIENCE.md) --------
        # The server's view of the world, adopted from WELCOME and from
        # ``resharded`` errors.  ``layers`` is the §6 cascade (outermost
        # first); ``orphans`` the descriptors rank 0 serves as a prefix.
        self.generation = 0
        self.world: Optional[int] = None if spec is None else int(spec.world)
        self.layers: list = []
        self.elastic_epoch: Optional[int] = None
        self.orphans: list = []
        #: memberships this client already streamed part of the current
        #: epoch under: ``{"rank","world","layers","orphans","samples"}``
        #: per generation ridden through — the degraded fallback replays
        #: exactly these prefixes (``local_epoch_indices``).
        self._trail: list = []
        self._epoch_samples = 0          # delivered watermark, current gen
        self._samples_epoch: Optional[int] = None
        self._leaving = False            # set by leave(): boundary = eof
        # -------- hot-standby failover (docs/RESILIENCE.md) --------
        #: the primary's standby, learned from WELCOME; the failover peer
        self.standby_address: Optional[tuple] = None
        #: highest fencing term seen; stamped on requests once > 0
        self.term = 0
        #: next HELLO asks the peer to promote (we are failing over)
        self._promote_on_connect = False
        #: perf_counter at failover start — observed into ``failover_ms``
        #: at the first successful WELCOME after it
        self._failover_t0: Optional[float] = None
        # -------- moving-horizon streaming (docs/STREAMING.md) --------
        #: attach-only (feeder) mode: HELLO binds the namespace without
        #: claiming a rank lease — a feeder holding a lease would count
        #: as a permanent straggler and deadlock the advance barrier
        self._attach = bool(attach)
        #: stable feeder id + monotonic per-append sequence: every retry
        #: of one logical APPEND carries the same ``(feeder, stream_seq)``
        #: pair, so a reply lost on the wire is re-answered as a
        #: duplicate, never double-counted.  The id must never repeat
        #: within a process lifetime — ``id(self)`` would, once a dead
        #: feeder is collected and its address reused, silently dedup a
        #: NEW feeder's first append as a replay
        with _FEEDER_LOCK:
            global _FEEDER_SEQ
            _FEEDER_SEQ += 1
            self._feeder = f"{os.getpid()}-{_FEEDER_SEQ}"
        self._stream_seq = -1

    # ----------------------------------------------------------- connection
    #: dial → redirect hops one ``_connect`` tolerates before handing the
    #: churn (a staggered cross-shard commit ping-pongs a migrating rank
    #: between the old and new owner) to the retry layer's paced loop
    _MAX_REDIRECT_HOPS = 6

    def _adopt_shard_map(self, wire) -> bool:
        """Version-gated map adoption: during a staggered cross-shard
        commit both the old and the new owner refuse a migrating rank,
        each attaching its own map — only a version >= ours may replace
        the adopted one (docs/SHARDING.md)."""
        if not wire:
            return False
        cur = self.shard_map
        if cur is not None and \
                int(wire.get("version", 1)) < int(cur.get("version", 1)):
            return False
        self.shard_map = dict(wire)
        return True

    def _shard_owner_addr(self, rank) -> Optional[tuple]:
        """The owning shard's address per the adopted map (``None``
        without a map, or when the map has no address for it); rankless
        auto-claim clients go to the first non-empty slice."""
        m = self.shard_map
        if m is None:
            return None
        for sh in m.get("shards", ()):
            lo, hi = int(sh["ranks"][0]), int(sh["ranks"][1])
            if hi <= lo:
                continue
            a = sh.get("addr")
            if rank is None:
                if a is not None:
                    return _parse_address(tuple(a))
                continue
            if lo <= int(rank) < hi:
                return None if a is None else _parse_address(tuple(a))
        return None

    def _on_wrong_shard(self, hdr: dict) -> None:
        """A shard refused our rank: adopt the attached (fresh) map and
        re-point at the owner — falling back to the router when the map
        carries no address for it."""
        self._adopt_shard_map(hdr.get("shard_map"))
        self.metrics.inc("wrong_shard_redirects", self.rank)
        target = self._shard_owner_addr(self.rank)
        if target is None:
            target = self._router_address
        if target is not None and target != self.address:
            self.close()
            self.address = target

    def _adopt_cell_directory(self, wire) -> bool:
        """Version-gated directory adoption — the ``_adopt_shard_map``
        rule one layer up: a stale wire copy riding a delayed refusal
        must never roll the global namespace back."""
        if not wire:
            return False
        cur = self.cell_directory
        if cur is not None and \
                int(wire.get("version", 1)) < int(cur.get("version", 1)):
            return False
        self.cell_directory = dict(wire)
        return True

    def _cell_addr(self, cell) -> Optional[tuple]:
        d = self.cell_directory
        if d is None or cell is None:
            return None
        a = (d.get("cells") or {}).get(str(cell))
        return None if a is None else _parse_address(tuple(a))

    def _home_cell(self) -> Optional[str]:
        """Our tenant's home cell per the adopted directory (the
        directory default when no explicit row names us)."""
        d = self.cell_directory
        if d is None:
            return None
        tenant = self.tenant
        if tenant is None and self.expected_spec is not None:
            tenant = tenant_id_for(
                self.expected_spec.fingerprint(include_world=False))
        if tenant is not None:
            home = (d.get("tenants") or {}).get(str(tenant))
            if home is not None:
                return home
        return d.get("default")

    def _on_wrong_cell(self, hdr: dict) -> None:
        """A cell refused our tenant: adopt the attached (fresh)
        directory and re-point at the home cell's entry address
        (docs/FEDERATION.md "Cell directory")."""
        self._adopt_cell_directory(hdr.get("cell_directory"))
        self.metrics.inc("wrong_cell_redirects", self.rank)
        target = self._cell_addr(hdr.get("home")) or \
            self._cell_addr(self._home_cell())
        if target is not None and target != self.address:
            self.close()
            self.address = target

    def _connect(self) -> None:
        last_refusal = None
        for _ in range(self._MAX_REDIRECT_HOPS):
            done, last_refusal = self._connect_once()
            if done:
                return
        if last_refusal is not None:
            # still ping-ponging (a staggered commit in flight): surface
            # the typed refusal so the retry layer paces the re-route
            raise _typed_error(last_refusal.get("code", "wrong_shard"),
                               last_refusal.get("detail", ""), last_refusal)
        raise ServiceUnavailable(
            f"still redirected toward {self.address} after "
            f"{self._MAX_REDIRECT_HOPS} hops; the shard map may be "
            "missing addresses")

    def _connect_once(self):
        """One dial + HELLO.  Returns ``(True, None)`` once a data-plane
        WELCOME is adopted; ``(False, refusal-or-None)`` when a router
        WELCOME or a ``wrong_shard`` refusal re-pointed ``self.address``
        at the owning shard (the caller loops, bounded)."""
        sock = socket.create_connection(self.address, timeout=self.timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(self.timeout)
        hello = {
            "proto": P.PROTOCOL_VERSION,
            "rank": -1 if self.rank is None else self.rank,
            "batch": self.batch,
        }
        if self.term > 0:
            hello["term"] = self.term
        if self._promote_on_connect:
            # failing over: ask the standby to promote (it will, once its
            # replication feed has been stale for repl_feed_timeout)
            hello["failover"] = True
        if self.expected_spec is not None:
            # world-stripped: under elastic membership the server's world
            # drifts legitimately; only the stream-shaping config must match
            hello["spec_fingerprint"] = \
                self.expected_spec.fingerprint(include_world=False)
            # the full wire spec lets a multi-tenant daemon CREATE the
            # tenant on first contact (docs/SERVICE.md "Tenancy"); a
            # single-tenant daemon ignores it
            hello["spec"] = self.expected_spec.to_wire()
        if self.tenant is not None:
            hello["tenant"] = self.tenant
        if self._attach:
            # feeder mode: admit the namespace only — no rank lease
            hello["attach"] = True
        try:
            P.send_msg(sock, P.MSG_HELLO, hello)
            msg, header, _ = P.recv_msg(sock)
        except BaseException:
            sock.close()
            raise
        if msg == P.MSG_ERROR:
            sock.close()
            if header.get("code") == "wrong_shard":
                self._on_wrong_shard(header)
                return False, header
            if header.get("code") == "wrong_cell":
                # our tenant is homed at another cell: re-point at its
                # entry address and loop (docs/FEDERATION.md)
                self._on_wrong_cell(header)
                return False, header
            raise _typed_error(header.get("code", "error"),
                               header.get("detail", ""), header)
        if self._attach and msg == P.MSG_OK:
            # attach-only HELLO is answered OK (not WELCOME): adopt the
            # tenant binding and keep the leaseless connection
            t = header.get("tenant")
            if t is not None:
                self.tenant = str(t)
            self._sock = sock
            self._promote_on_connect = False
            return True, None
        if msg != P.MSG_WELCOME:
            sock.close()
            raise P.ProtocolError(
                f"expected WELCOME, got {P.msg_name(msg)}"
            )
        c = header.get("cell")
        if c is not None:
            # federated deployment: remember the serving cell and adopt
            # the directory BEFORE the router early-return — a router
            # WELCOME carries the namespace too (docs/FEDERATION.md)
            self.cell = str(c)
            self._adopt_cell_directory(header.get("cell_directory"))
        if header.get("router"):
            # a ShardRouter answered: it never serves data — remember it,
            # adopt the map it carries and direct-connect the owning
            # shard (docs/SHARDING.md)
            sock.close()
            self._router_address = self.address
            self._adopt_shard_map(header.get("shard_map"))
            target = self._shard_owner_addr(self.rank)
            if target is None or target == self.address:
                raise ServiceUnavailable(
                    f"router at {self.address} advertised no shard "
                    f"address for rank {self.rank}")
            self.address = target
            return False, None
        sm = header.get("shard_map")
        if sm is not None:
            self._adopt_shard_map(sm)
        self.rank = int(header["rank"])
        t = header.get("tenant")
        if t is not None:
            self.tenant = str(t)
        self.spec_wire = header.get("spec")
        self.server_epoch = header.get("epoch")
        sb = header.get("standby")
        if sb is not None:
            self.standby_address = _parse_address(sb)
        t = header.get("term")
        if t is not None:
            self.term = max(self.term, int(t))
        mi = header.get("max_inflight")
        if mi is not None:
            self._server_max_inflight = max(1, int(mi))
        bh = header.get("batch_hint")
        if bh is not None:
            # autopilot-tuned batch suggestion (docs/AUTOPILOT.md);
            # adopted at the next clean epoch boundary, never mid-epoch
            # — the seq unit IS the batch size
            self._batch_hint = max(1, int(bh))
        self._adopt_membership(header)
        self._sock = sock
        self._promote_on_connect = False
        if self._failover_t0 is not None:
            self.metrics.registry.histogram("failover_ms").observe(
                (time.perf_counter() - self._failover_t0) * 1e3)
            self._failover_t0 = None
        return True, None

    def _adopt_membership(self, header: dict) -> None:
        """Take on the membership a WELCOME or ``resharded`` error carries.

        When the generation advanced past ours and we had already
        delivered part of the current epoch, the outgoing membership is
        pushed onto the trail with its exact delivered watermark — the
        degraded fallback later replays precisely those prefixes."""
        if "generation" not in header:
            return
        gen = int(header["generation"])
        if gen < self.generation:
            # a behind peer (a standby promoted before the dead primary
            # shipped its last commit): keep our newer membership — the
            # stream loop flushes our acks so the peer catches up
            return
        if gen > self.generation:
            if self.world is not None and self.rank is not None:
                self._trail.append({
                    "rank": self.rank, "world": self.world,
                    "layers": [tuple(map(int, l)) for l in self.layers],
                    "orphans": list(self.orphans),
                    "samples": int(self._epoch_samples),
                })
            self._epoch_samples = 0
            if self._samples_epoch is not None:
                # only a client that was already streaming rode through;
                # a fresh HELLO adopting a resharded server's membership
                # didn't cross a world change
                self.metrics.inc("reshards_ridden", self.rank)
        self.generation = gen
        self.world = int(header["world"])
        self.layers = [tuple(map(int, l)) for l in header.get("layers", [])]
        ee = header.get("elastic_epoch")
        self.elastic_epoch = None if ee is None else int(ee)
        self.orphans = list(header.get("orphans", []))

    def _ensure_connected(self) -> None:
        if self._sock is None:
            self._connect()

    def probe(self) -> bool:
        """One connection attempt, no retries: is a daemon serving right
        now?  The degraded-mode loader polls this to decide when to
        re-attach; a False answer leaves the client closed and costs one
        refused TCP dial."""
        if self._sock is not None:
            return True
        try:
            self._connect()
            self.retry_policy.record_success()
            return True
        except (OSError, ServiceError, P.ProtocolError):
            # includes ConnectionError/timeout; fatal config mismatches
            # also read as "not attachable" here — the next real stream
            # attempt surfaces them loudly
            self.close()
            return False

    def close(self) -> None:
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def __enter__(self) -> "ServiceIndexClient":
        self._ensure_connected()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---------------------------------------------------------------- retry
    def _rpc(self, msg_type: int, header: dict):
        """One request → reply, retrying across connection loss.

        Every message this client sends is idempotent, so a reconnect +
        replay can never double-deliver.  All waiting rides the unified
        :class:`RetryPolicy` (full-jittered exponential backoff under one
        per-operation deadline) — reconnects and lease races alike, so N
        ranks dropped by one restart never retry in lockstep.  A server
        ``throttle``/``draining`` reply sleeps at least the
        server-suggested interval.  The policy's circuit breaker makes a
        freshly-exhausted dependency fail fast at the *next* operation's
        entry instead of burning its full deadline again.

        One telemetry span covers the whole operation — retries included —
        so its ``trace`` context, stamped into the request header, is by
        construction the same across every attempt of one logical request
        (docs/OBSERVABILITY.md).  The ``rpc_ms`` histogram observes the
        operation wall time whether or not tracing is on."""
        t0 = time.perf_counter()
        if not _tel_enabled():
            # tracing off: skip span construction entirely — no kwargs
            # dict, no msg-name lookup, no thread-local push on the
            # per-request hot path
            try:
                return self._rpc_attempts(msg_type, header)
            finally:
                self.metrics.registry.histogram("rpc_ms").observe(
                    (time.perf_counter() - t0) * 1e3)
        with _span("client.rpc", msg=P.msg_name(msg_type),
                   rank=self.rank) as sp:
            ctx = sp.ids
            if ctx is not None:
                header["trace"] = ctx
            try:
                return self._rpc_attempts(msg_type, header)
            finally:
                self.metrics.registry.histogram("rpc_ms").observe(
                    (time.perf_counter() - t0) * 1e3)

    def _rpc_attempts(self, msg_type: int, header: dict):
        pol = self.retry_policy
        if not pol.allow():
            raise ServiceUnavailable(
                f"circuit open toward {self.address} (recent operations "
                "exhausted their retry deadlines); next probe after "
                f"{pol.breaker_reset}s"
            )
        op = pol.begin()
        # peers whose retry budget this operation already opened: the
        # current one now, the standby if we fail over to it.  Failover
        # is a per-PEER budget (``_begin_failover`` calls ``begin()``
        # again) — the dead primary's exhausted deadline never bills the
        # standby.
        tried = {self.address}
        while True:
            try:
                try:
                    self._ensure_connected()
                except ServiceError as exc:
                    if exc.code == "standby":
                        op = self._on_standby(exc, op, tried)
                        continue
                    if exc.code == "fenced":
                        op = self._on_fenced(exc.header, op, tried)
                        continue
                    if exc.code == "tenant_admission":
                        # typed admission backpressure: the tenant is at a
                        # quota (ranks / creation burst) — wait at least
                        # the server-suggested interval and re-HELLO
                        self.metrics.inc("admission_waits", self.rank)
                        retry_s = float(
                            exc.header.get("retry_ms", 50)) / 1e3
                        if not op.pause(min_delay=retry_s):
                            raise
                        continue
                    if exc.code in ("wrong_shard", "router_route",
                                    "wrong_cell"):
                        # shard-map churn (a staggered cross-shard commit
                        # ping-pongs a migrating rank between owners), an
                        # injected route fault, or a cross-cell redirect
                        # mid-flip: the re-route already happened in
                        # _connect — pace and re-dial
                        retry_s = float(
                            exc.header.get("retry_ms", 25)) / 1e3
                        if not op.pause(min_delay=retry_s):
                            raise
                        continue
                    if exc.code not in ("rank_taken", "not_owner"):
                        raise
                    # our own just-dropped lease may not have been released
                    # yet (the server notices the dead conn asynchronously);
                    # back off and re-HELLO like any other lease race
                    if not op.pause():
                        raise
                    continue
                if "rank" in header:
                    # the lazy connect (or a re-HELLO after lease loss) is
                    # what assigns auto-claimed ranks — stamp the current
                    # one on every attempt
                    header["rank"] = self.rank
                if self.term > 0:
                    # the fencing term rides every post-promotion request:
                    # a zombie primary must refuse, not serve, it
                    header["term"] = self.term
                if self.tenant is not None:
                    # the tenant binding rides every request: a server-side
                    # conn that lost its HELLO binding (or a promoted
                    # standby) still routes to the right namespace
                    header["tenant"] = self.tenant
                P.send_msg(self._sock, msg_type, header,
                           site="service.send")
                reply, rheader, payload = P.recv_msg(self._sock,
                                                     site="service.recv")
            except (ConnectionError, socket.timeout, OSError,
                    P.ProtocolError) as exc:
                self.close()
                self.metrics.inc("reconnects", self.rank)
                pol.record_failure()
                if not op.pause():
                    peer = self._failover_peer(tried)
                    if peer is None:
                        raise ServiceUnavailable(
                            f"no server at {self.address} after "
                            f"{op.attempts} attempts ({exc!r})"
                        ) from None
                    op = self._begin_failover(peer, tried)
                continue
            pol.record_success()
            if reply == P.MSG_ERROR:
                code = rheader.get("code", "error")
                if code == "throttle":
                    self.metrics.inc("throttled", self.rank)
                    time.sleep(float(rheader.get("retry_ms", 20)) / 1e3)
                    continue
                if code == "draining":
                    # graceful shutdown in progress: drop the conn and come
                    # back after (at least) the server-suggested interval
                    self.close()
                    self.metrics.inc("drain_redirects", self.rank)
                    retry_s = float(rheader.get("retry_ms", 100)) / 1e3
                    if not op.pause(min_delay=retry_s):
                        raise ServiceUnavailable(
                            f"server at {self.address} is draining and did "
                            "not return within the retry deadline"
                        )
                    continue
                if code == "not_owner" or code == "rank_taken":
                    # lease lost (eviction or a racing claimant): re-HELLO
                    # once the stale claimant's lease clears; fatal only if
                    # it never does within the deadline
                    self.close()
                    if not op.pause():
                        raise ServiceError(code, rheader.get("detail", ""),
                                           rheader)
                    continue
                if code == "reshard":
                    # a barrier is freezing/draining: wait it out on this
                    # side of the retry deadline — the post-commit replay
                    # of the same request is exactly-once by construction
                    self.metrics.inc("reshard_waits", self.rank)
                    retry_s = float(rheader.get("retry_ms", 50)) / 1e3
                    if not op.pause(min_delay=retry_s):
                        raise ReshardInProgress(
                            f"reshard barrier at {self.address} did not "
                            "commit within the retry deadline"
                        )
                    continue
                if code == "wrong_shard":
                    # our rank moved shards (a cross-shard reshard
                    # commit): adopt the attached map, re-point at the
                    # owner and re-HELLO there (docs/SHARDING.md)
                    self.close()
                    self._on_wrong_shard(rheader)
                    retry_s = float(rheader.get("retry_ms", 25)) / 1e3
                    if not op.pause(min_delay=retry_s):
                        raise ServiceError(code, rheader.get("detail", ""),
                                           rheader)
                    continue
                if code == "wrong_cell":
                    # our tenant migrated cells mid-stream: adopt the
                    # fresh directory, re-point at the new home cell and
                    # re-HELLO there — the cursor law makes the replay
                    # exactly-once (docs/FEDERATION.md)
                    self.close()
                    self._on_wrong_cell(rheader)
                    retry_s = float(rheader.get("retry_ms", 25)) / 1e3
                    if not op.pause(min_delay=retry_s):
                        raise ServiceError(code, rheader.get("detail", ""),
                                           rheader)
                    continue
                if code in ("horizon_pending", "horizon_advance",
                            "stream_append"):
                    # moving-horizon backpressure (docs/STREAMING.md):
                    # the horizon is not fully appended yet, the advance
                    # barrier is waiting on straggler ranks (or an
                    # injected abort rolled it back), or an injected
                    # append fault fired.  All retryable: GET_BATCH/
                    # GET_CAPABILITY replays are exactly-once by the
                    # cursor law, and APPEND replays are deduplicated by
                    # ``(feeder, stream_seq)``.
                    self.metrics.inc("stream_waits", self.rank)
                    retry_s = float(rheader.get("retry_ms", 25)) / 1e3
                    if not op.pause(min_delay=retry_s):
                        raise ServiceError(code, rheader.get("detail", ""),
                                           rheader)
                    continue
                if code == "capability_issue":
                    # transient issuance refusal (an injected fault, or
                    # a daemon mid-hiccup): GET_CAPABILITY is idempotent
                    # — pace by the server's hint and replay
                    retry_s = float(rheader.get("retry_ms", 50)) / 1e3
                    if not op.pause(min_delay=retry_s):
                        raise ServiceError(code, rheader.get("detail", ""),
                                           rheader)
                    continue
                if code in ("router_route", "shard_barrier"):
                    # transient control-plane trouble (an injected route
                    # fault, or a cross-shard barrier fan-out that did
                    # not complete): every frame we send is idempotent,
                    # so pace and replay
                    retry_s = float(rheader.get("retry_ms", 50)) / 1e3
                    if not op.pause(min_delay=retry_s):
                        raise ServiceError(code, rheader.get("detail", ""),
                                           rheader)
                    continue
                if code == "standby":
                    # the peer demoted/never promoted under us
                    self.close()
                    op = self._on_standby(
                        ServiceError(code, rheader.get("detail", ""),
                                     rheader), op, tried)
                    continue
                if code == "fenced":
                    self.close()
                    op = self._on_fenced(rheader, op, tried)
                    continue
                raise _typed_error(code, rheader.get("detail", ""), rheader)
            return reply, rheader, payload

    # ----------------------------------------------------------- failover
    def _failover_peer(self, tried) -> Optional[tuple]:
        """The peer this operation has not yet spent a budget on (the
        standby learned at WELCOME), or None when every peer is spent —
        the caller's signal that both peers are down.  On a sharded
        deployment the router is the peer of last resort: a merged-out
        shard's address dies for good, but the router's fresh map
        re-points us at whichever shard owns our rank now."""
        sb = self.standby_address
        if sb is not None and sb not in tried:
            return sb
        ra = self._router_address
        if ra is not None and ra not in tried and ra != self.address:
            return ra
        # cell-aware dial ladder (docs/FEDERATION.md): past the in-cell
        # peers, re-look-up our home cell in the adopted directory, then
        # knock on its DR partner — the whole home cell may be gone
        home = self._home_cell()
        for cell in (home, self._dr_cell(home)):
            a = self._cell_addr(cell)
            if a is not None and a not in tried and a != self.address:
                return a
        return None

    def _dr_cell(self, cell) -> Optional[str]:
        d = self.cell_directory
        if d is None or cell is None:
            return None
        return (d.get("dr") or {}).get(str(cell))

    def _begin_failover(self, peer: tuple, tried: set):
        """Point the client at ``peer`` under a FRESH retry deadline and
        budget — the whole point of per-peer budgets: a standby must get
        its full window, not the dead primary's leftovers."""
        self.close()
        self.address = peer
        tried.add(peer)
        self._promote_on_connect = True
        if self._failover_t0 is None:
            self._failover_t0 = time.perf_counter()
        self.metrics.inc("failovers", self.rank)
        # the new peer gets a clean breaker slate too: the consecutive
        # failures that exhausted the old peer say nothing about this one
        self.retry_policy.record_success()
        return self.retry_policy.begin()

    def _on_standby(self, exc: ServiceError, op, tried):
        """The peer answered ``standby``.  A healthy pair redirects us to
        its primary; mid-failover we keep knocking (the standby promotes
        once its feed goes stale) until this peer's budget is spent."""
        hdr = exc.header
        t = hdr.get("term")
        if t is not None:
            self.term = max(self.term, int(t))
        primary = hdr.get("primary")
        if not self._promote_on_connect and primary is not None:
            redirect = _parse_address(primary)
            if redirect != self.address and redirect not in tried:
                self.close()
                self.address = redirect
                tried.add(redirect)
                return op
        if not op.pause(min_delay=float(hdr.get("retry_ms", 100)) / 1e3):
            peer = self._failover_peer(tried)
            if peer is None:
                raise exc
            return self._begin_failover(peer, tried)
        return op

    def _on_fenced(self, hdr: dict, op, tried):
        """The peer answered ``fenced``: a promotion happened.  Adopt the
        winning term; when the refuser itself keeps serving at that term
        (``serving=true`` — our stamp was merely stale) just retry it,
        otherwise it is a zombie and we fail over to the winner."""
        t = int(hdr.get("term", 0))
        if t > self.term:
            self.term = t
        self.metrics.inc("fenced_replies", self.rank)
        if hdr.get("serving"):
            return op
        peer = self._failover_peer(tried)
        if peer is None:
            raise FencedError(
                t, f"every reachable peer is fenced below term {t} and "
                   "no serving primary is attached", hdr)
        return self._begin_failover(peer, tried)

    # ------------------------------------------------------------- batches
    def _pipe_limit(self) -> int:
        """The effective lookahead window: the ``lookahead`` knob,
        clamped by the server's WELCOME-advertised ``max_inflight`` and
        by any cap learned from a throttle refusal mid-pipeline."""
        lim = self.lookahead
        if self._server_max_inflight is not None:
            lim = min(lim, self._server_max_inflight)
        if self._pipe_cap is not None:
            lim = min(lim, self._pipe_cap)
        return max(1, lim)

    def _pipe_header(self, epoch: int, seqno: int, ack: int,
                     gen: int) -> dict:
        h = {"rank": self.rank, "epoch": epoch, "seq": seqno,
             "ack": ack, "gen": gen}
        if self.term > 0:
            h["term"] = self.term
        if self.tenant is not None:
            h["tenant"] = self.tenant
        return h

    def _drain_replies(self, sock, n: int) -> None:
        """Read and discard the replies to still-in-flight pipelined
        requests — the server answers every request exactly once, in
        order, so the count is known.  Discarded batches are *unacked*:
        re-requesting them through the guarded path is exactly-once by
        construction (the cursor only advances on yield)."""
        for _ in range(n):
            P.recv_msg(sock)

    def _pipelined_batches(self, epoch: int, seq: int, gen: int,
                           rejects: int):
        """The fused steady-state serve path: keep up to
        ``_pipe_limit()`` GET_BATCH requests in flight, topping the
        window up with ONE coalesced send per delivered batch
        (``P.send_msgs``) so the next reply is already in the socket
        buffer while the consumer holds the current batch.

        Exactly-once survives any failure here because the cursor
        advances only when a batch is yielded: every in-flight request
        past the cursor is unacked, so tearing the connection (or
        discarding queued replies after a typed error) merely re-requests
        those seqs through the guarded `_rpc` path.

        Returns ``(done, seq, rejects)``; ``done`` means the epoch
        stream completed.  Any error/typed refusal returns ``done=False``
        and lets ``epoch_batches`` recover through the guarded path.
        The terminal EOF poll is ALWAYS left to the guarded path: its
        ack (the epoch's last delivered batch) gates elastic drain
        barriers, so it must ride `_rpc`'s reshard-wait machinery, not a
        fire-and-forget pipeline slot."""
        sock = self._sock
        hist = self.metrics.registry.histogram("step_serve_ms")
        pending = deque()        # requested-but-unconsumed seqs, in order
        next_req = seq
        bound = None             # request-seq bound once total is known
        hb_seq = None            # seq of the request carrying _pending_hb
        ramp = 1                 # slow-start: the window grows one per
        #                          delivered batch, so a cold epoch is
        #                          never one indivisible burst (and the
        #                          stream total is learned before more
        #                          than one request is committed)
        try:
            while True:
                # re-read the clamp every iteration: a failover re-HELLO
                # can adopt a SMALLER max_inflight mid-stream, and an
                # already-ramped window must shrink to it — no new
                # request is sent until the in-flight span drains below
                # the new limit, so the standby never sees a window the
                # dead primary negotiated
                w = self._pipe_limit()
                if ramp > w:
                    ramp = w
                msgs = []
                while len(pending) < min(w, ramp) and (bound is None
                                                       or next_req < bound):
                    h = self._pipe_header(epoch, next_req, seq - 1, gen)
                    if self._pending_hb is not None and hb_seq is None:
                        h["hb"] = list(self._pending_hb)
                        hb_seq = next_req
                    msgs.append((P.MSG_GET_BATCH, h))
                    pending.append(next_req)
                    next_req += 1
                if msgs:
                    F.fire("client.pipeline")
                    self.metrics.inc("rpcs_per_step", self.rank,
                                     value=len(msgs))
                    P.send_msgs(sock, msgs, site="service.send")
                if not pending:
                    # every real batch is delivered: hand the terminal
                    # EOF poll (and its drain-gating ack) to the guarded
                    # path
                    return False, seq, rejects
                t0 = time.perf_counter()
                reply, rheader, payload = P.recv_msg(sock,
                                                     site="service.recv")
                expect = pending.popleft()
                if reply == P.MSG_ERROR:
                    code = rheader.get("code", "error")
                    if code == "throttle":
                        # server window smaller than ours (a peer that
                        # predates the WELCOME advertisement): shrink
                        # and let the guarded path resume
                        self.metrics.inc("throttled", self.rank)
                        self._pipe_cap = max(1, (len(pending) + 1) // 2)
                    self._drain_replies(sock, len(pending))
                    return False, seq, rejects
                if reply != P.MSG_BATCH or int(rheader.get("seq",
                                                           -1)) != expect:
                    raise P.ProtocolError(
                        f"pipelined reply out of order: expected BATCH "
                        f"seq {expect}, got {P.msg_name(reply)} seq "
                        f"{rheader.get('seq')}")
                if expect == hb_seq:
                    # the piggybacked previous-epoch ack landed
                    self._pending_hb = None
                    hb_seq = None
                if rheader.get("end") is not None:
                    self._epoch_samples = max(self._epoch_samples,
                                              int(rheader["end"]))
                if rheader.get("eof"):
                    # only an entry-point request (resume at the epoch
                    # tail) can draw an EOF here — its own ack was the
                    # terminal one, so the stream is complete
                    self._drain_replies(sock, len(pending))
                    return True, seq, rejects
                try:
                    arr = P.decode_indices(rheader, payload)
                except P.ChecksumError:
                    rejects += 1
                    self.metrics.inc("checksum_rejects", self.rank)
                    if rejects > _MAX_CHECKSUM_REJECTS:
                        raise
                    # unacked: the guarded path re-requests this seq and
                    # everything queued behind it
                    self._drain_replies(sock, len(pending))
                    return False, seq, rejects
                rejects = 0
                ramp = min(w, ramp + 1)
                if bound is None and rheader.get("total") is not None:
                    # cap requests at the last REAL batch; the EOF poll
                    # stays on the guarded path (see docstring)
                    bound = -(-int(rheader["total"]) // self.batch)
                self.metrics.inc("batches_served", self.rank)
                seq += 1
                self._cursor = {"epoch": epoch, "seq": seq}
                hist.observe((time.perf_counter() - t0) * 1e3)
                yield arr
        except P.ChecksumError:
            raise
        except (ConnectionError, socket.timeout, OSError,
                P.ProtocolError):
            # the connection (and every queued reply) is gone; all of it
            # was unacked, so the guarded path replays it exactly-once
            self.close()
            self.metrics.inc("reconnects", self.rank)
            return False, seq, rejects

    def epoch_batches(self, epoch: int, *,
                      start_seq: int = 0) -> Iterator[np.ndarray]:
        """Stream the rank's batches for ``epoch`` from ``start_seq`` on.

        On a healthy connection the stream is *pipelined*: up to
        ``lookahead`` GET_BATCH requests ride in flight (clamped by the
        server's ``max_inflight``), topped up with one coalesced send
        per delivered batch, so the per-step cost is one socket read of
        an already-buffered reply.  Each request still acks everything
        this generator already yielded — the in-flight window is exactly
        the unacked span the server's throttle gate admits — and the
        previous epoch's terminal ack piggybacks on the next epoch's
        first request (header field ``hb``) instead of a dedicated EOF
        poll.  Any fault or typed refusal drops to the guarded
        request-reply path below, which re-requests from the cursor:
        delivery stays exactly-once because the cursor advances only on
        yield, never on receipt.

        Rides through reshards: a ``resharded`` reply (or reconnect) makes
        the generator adopt the new membership, renegotiate a rank if its
        old one no longer exists, and continue with the post-reshard
        remainder — one contiguous exactly-once stream across the world
        change.  It ends early (without error) only when the rank *left*
        (terminal drain eof) or the shrunken world has no free slot left
        (``membership_lost`` in the metrics)."""
        epoch, seq = int(epoch), int(start_seq)
        if (self.auto_batch and seq == 0 and self._batch_hint is not None
                and int(self._batch_hint) != self.batch):
            # clean boundary: nothing is delivered at this batch
            # geometry yet.  The lease's batch is bound at HELLO, so
            # adopt by re-dialing — the next request re-HELLOs with the
            # new size, and the queued previous-epoch ``hb`` ack still
            # rides that first request (docs/AUTOPILOT.md)
            self.close()
            self.batch = int(self._batch_hint)
        self._cursor = {"epoch": epoch, "seq": seq}
        if self._samples_epoch != epoch:
            # new epoch: the trail describes the previous epoch's
            # deliveries — start fresh
            self._trail = []
            self._epoch_samples = 0
            self._samples_epoch = epoch
        rejects = 0
        gen = self.generation
        behind_t0 = None
        hist = self.metrics.registry.histogram("step_serve_ms")
        while True:
            if self.generation != gen:
                # a reconnect inside _rpc adopted a newer membership
                # (WELCOME on our still-valid rank): continue from the
                # head of the post-reshard remainder
                gen, seq = self.generation, 0
                self._cursor = {"epoch": epoch, "seq": seq}
            if (self._sock is not None and not self._leaving
                    and self._pipe_limit() > 1 and not _tel_enabled()):
                # fused fast path (tracing keeps the one-span-per-RPC
                # guarded path for attribution; a leaving rank must see
                # its terminal drain eof, served by the guarded path)
                done, seq, rejects = yield from self._pipelined_batches(
                    epoch, seq, gen, rejects)
                if done:
                    return
                if self.generation != gen:
                    continue
            # guarded request-reply path: recovery, lookahead=1, tracing
            t_req = time.perf_counter()
            req = {"rank": self.rank, "epoch": epoch, "seq": seq,
                   "ack": seq - 1, "gen": gen}
            if self._pending_hb is not None:
                req["hb"] = list(self._pending_hb)
            self.metrics.inc("rpcs_per_step", self.rank)
            try:
                reply, header, payload = self._rpc(P.MSG_GET_BATCH, req)
            except ServiceError as exc:
                if exc.code == "resharded":
                    if self._leaving:
                        # we asked to LEAVE and the barrier committed:
                        # our pre-barrier allocation is fully served
                        # (the commit required our drain), so this is
                        # the stream's end, not a membership to ride
                        return
                    # the world changed underneath us: adopt the carried
                    # membership and continue the stream under it
                    prev_gen = self.generation
                    self._adopt_membership(exc.header)
                    if self.generation == prev_gen:
                        # a failover raced a commit the dead primary never
                        # shipped: the promoted standby is still draining
                        # the barrier we already rode through.  Flush our
                        # pre-barrier delivered-ack watermark so its drain
                        # can complete, then retry at the SAME cursor —
                        # resetting seq here would double-serve.
                        if behind_t0 is None:
                            behind_t0 = time.monotonic()
                        elif (time.monotonic() - behind_t0
                                > self.reconnect_timeout):
                            raise ReshardInProgress(
                                f"peer at {self.address} stayed a "
                                "generation behind past the reconnect "
                                "deadline") from None
                        self._queue_trail_ack(epoch)
                        time.sleep(min(0.05, self.backoff_base))
                        continue
                    behind_t0 = None
                    if not (self.rank is not None and self.world is not None
                            and self.rank < self.world):
                        if not exc.header.get("vacated"):
                            # shrunk out with no slot vacated for a
                            # rejoin: the commit already drained (or
                            # orphaned) our whole pre-barrier span, and
                            # claiming a slot a survivor merely finished
                            # and freed would re-serve its stream — seen
                            # at failover, when the survivor finishes
                            # before our reconnect budget sends us here
                            self.metrics.inc("membership_lost")
                            return
                        # our rank no longer exists — auto-claim the
                        # vacated slot (typically the leaver's)
                        self.close()
                        self.rank = None
                    gen, seq = self.generation, 0
                    self._cursor = {"epoch": epoch, "seq": seq}
                    continue
                if exc.code == "no_rank" and self.rank is None:
                    # the world shrank past us and every surviving slot is
                    # claimed: our share of the epoch belongs to others now
                    self.metrics.inc("membership_lost")
                    return
                raise
            if reply != P.MSG_BATCH:
                raise P.ProtocolError(
                    f"expected BATCH, got {P.msg_name(reply)}"
                )
            if "hb" in req:
                # the piggybacked previous-epoch ack landed server-side
                self._pending_hb = None
            if header.get("eof"):
                # a terminal drain eof additionally carries left=True; in
                # both cases the stream for this rank is complete
                if header.get("end") is not None:
                    self._epoch_samples = max(self._epoch_samples,
                                              int(header["end"]))
                return
            try:
                arr = P.decode_indices(header, payload)
            except P.ChecksumError:
                # the payload arrived corrupted; the reply is idempotent,
                # so reject it and re-request the SAME seq — the delivered
                # stream stays exact.  Persistent corruption is a broken
                # link, not a transient: give up after a few replays.
                rejects += 1
                self.metrics.inc("checksum_rejects", self.rank)
                if rejects > _MAX_CHECKSUM_REJECTS:
                    raise
                continue
            rejects = 0
            self.metrics.inc("batches_served", self.rank)
            # advance BEFORE yielding: once the consumer holds the batch it
            # counts as delivered, so a state_dict() taken between batches
            # resumes at the next one (exactly-once, not at-least-once)
            seq += 1
            self._cursor = {"epoch": epoch, "seq": seq}
            if header.get("end") is not None:
                # exact delivered watermark in the current generation's
                # stream — what the trail records at the next adoption
                self._epoch_samples = max(self._epoch_samples,
                                          int(header["end"]))
            hist.observe((time.perf_counter() - t_req) * 1e3)
            yield arr

    def epoch_indices(self, epoch: int) -> np.ndarray:
        """The rank's full epoch stream as one array — the drop-in for a
        local sampler's ``epoch_indices`` (``HostDataLoader`` consumes
        this when constructed with ``index_client=``)."""
        parts = list(self.epoch_batches(epoch))
        if not parts:
            return np.empty(0, dtype=np.int64)
        return np.concatenate(parts)

    # ----------------------------------------------------------- control ops
    def set_epoch(self, epoch: int, *, weights_delta=None) -> int:
        """Move the server to ``epoch``.  ``weights_delta`` (prioritized
        sampling specs only, docs/SAMPLING.md) is an additive per-source
        re-weight folded into the weights effective at the new epoch —
        the streaming ``weights_delta`` law applied at an epoch
        boundary.  Zero protocol bytes when omitted."""
        body = {"epoch": int(epoch)}
        if weights_delta is not None:
            body["weights_delta"] = [int(x) for x in weights_delta]
        _, header, _ = self._rpc(P.MSG_SET_EPOCH, body)
        self.server_epoch = int(header["epoch"])
        return self.server_epoch

    def heartbeat(self) -> int:
        """Keepalive; also carries the delivered-ack cursor, so an idle
        client still completes an elastic drain — the barrier commits on
        *acked* delivery, not on served bytes.  A queued ``hb`` ack (a
        trail-ack a behind peer still needs) piggybacks here too.
        Returns the server's current generation — the cheap
        membership-freshness probe the loader's boundary prefetch uses."""
        header = {"rank": self.rank}
        if self._cursor["epoch"] is not None:
            header["epoch"] = int(self._cursor["epoch"])
            header["ack"] = int(self._cursor["seq"]) - 1
        if self._pending_hb is not None:
            header["hb"] = list(self._pending_hb)
        _, rheader, _ = self._rpc(P.MSG_HEARTBEAT, header)
        if "hb" in header:
            self._pending_hb = None
        # capability-mode drain discovery: while a barrier drains, the
        # reply names this rank's drain watermark (additive field;
        # served-batch clients never see it)
        self._cap_drain = rheader.get("cap_drain")
        kn = rheader.get("knobs")
        if kn:
            self._adopt_knobs(kn)
        return int(rheader.get("generation", self.generation))

    def _adopt_knobs(self, kn: dict) -> None:
        """Adopt autopilot-tuned knobs riding a heartbeat reply
        (docs/AUTOPILOT.md).  ``max_inflight`` applies live — the
        pipelined top-up re-reads it on every send — while a batch
        hint waits for the next epoch boundary, because mid-epoch the
        seq unit is the batch and re-slicing delivered spans would
        break exactly-once."""
        mi = kn.get("max_inflight")
        if mi is not None:
            self._server_max_inflight = max(1, int(mi))
        bh = kn.get("batch_hint")
        if bh is not None:
            self._batch_hint = max(1, int(bh))

    def _queue_trail_ack(self, epoch: int) -> None:
        """Queue the pre-barrier ack watermark (the trail's last recorded
        delivery) as a piggybacked ``hb`` on the next request, so a
        generation-behind peer's inherited drain gate — which commits on
        *acked* delivery — can complete the barrier the dead primary
        never shipped the commit of, without a dedicated heartbeat RPC
        (the server applies ``hb`` before its generation check)."""
        if not self._trail:
            return
        samples = int(self._trail[-1].get("samples", 0))
        ack = -(-samples // self.batch) - 1  # ceil(samples/batch) - 1
        if ack < 0:
            return
        self._pending_hb = [int(epoch), ack]

    def snapshot(self) -> dict:
        _, header, _ = self._rpc(P.MSG_SNAPSHOT, {})
        return header["state"]

    def server_metrics(self) -> dict:
        _, header, _ = self._rpc(P.MSG_METRICS, {})
        return header["report"]

    def trace_dump(self, limit: int = 256) -> dict:
        """Pull the server's recent telemetry — the flight-recorder ring
        plus its open spans (docs/OBSERVABILITY.md).  Returns the
        TRACE_REPORT header: ``{"enabled": bool, "entries": [...]}``.
        ``entries`` is empty (not an error) when the server runs with
        tracing off."""
        _, header, _ = self._rpc(P.MSG_TRACE_DUMP, {"limit": int(limit)})
        return header

    # ------------------------------------------------------------- elastic
    def leave(self, grace_ms: Optional[int] = None) -> dict:
        """Preemption-notice drain (hook this to SIGTERM): ask the server
        to reshard the world down by one and drain this rank out.

        Returns the server's OK header; when its ``reshard`` field is
        True it carries ``target_world`` and this rank's
        ``target_samples`` drain watermark — keep consuming
        ``epoch_batches`` until the terminal eof so the barrier can
        commit.  ``grace_ms`` bounds how long the server waits for that
        drain before declaring this rank dead and orphaning the
        un-served remainder (``None`` = wait indefinitely)."""
        F.fire("client.leave")
        header = {"rank": self.rank}
        if grace_ms is not None:
            header["grace_ms"] = int(grace_ms)
        _, rheader, _ = self._rpc(P.MSG_LEAVE, header)
        self.metrics.inc("leaves", self.rank)
        if rheader.get("reshard"):
            # commit requires our drain, so by the time the generation
            # moves on we have served the full pre-barrier allocation —
            # the boundary IS our terminal eof, whether it arrives as the
            # drain eof or as a post-commit ``resharded`` reply
            self._leaving = True
        return rheader

    def reshard(self, new_world: int) -> dict:
        """Explicit mid-epoch world change: freeze a barrier at every
        rank's consumption watermark and repartition the remainder over
        ``new_world`` ranks (SPEC.md §6 cascade).  Returns the server's
        OK header (``committed`` is True when the barrier already
        drained — e.g. all ranks idle — and the new generation is live)."""
        _, rheader, _ = self._rpc(P.MSG_RESHARD, {"world": int(new_world)})
        return rheader

    # ----------------------------------------------------------- streaming
    def append(self, count: int, *, weights_delta=None) -> dict:
        """Feeder op (docs/STREAMING.md): extend the stream's append-only
        index space by ``count`` samples.  Exactly-once under the retry
        layer — one logical append carries one ``(feeder, stream_seq)``
        pair across every wire attempt, and the server answers a replay
        as ``duplicate`` without re-counting.  ``weights_delta`` is an
        additive per-source mixture re-weighting, folded in at the next
        horizon advance.  Feeders should connect with ``attach=True`` so
        they never hold a rank lease (a leased feeder would stall the
        advance barrier as a permanent straggler).  Returns the OK
        header: ``appended`` (absolute total), ``eligible`` (servable
        horizons) and ``epoch`` (the stream's current horizon)."""
        self._stream_seq += 1
        header = {"count": int(count), "stream_seq": int(self._stream_seq),
                  "feeder": self._feeder}
        if weights_delta is not None:
            header["weights_delta"] = [int(x) for x in weights_delta]
        _, rheader, _ = self._rpc(P.MSG_APPEND, header)
        return rheader

    def stream_batches(self, *, start_horizon: int = 0,
                       horizons: Optional[int] = None,
                       start_seq: int = 0) -> Iterator[np.ndarray]:
        """The epochless consumption loop: serve horizon generations
        ``start_horizon, start_horizon + 1, ...`` back to back, each via
        :meth:`epoch_batches`.  No explicit advance call exists — the
        first request naming the next horizon *is* the ack-gated advance
        barrier, and the typed ``horizon_pending``/``horizon_advance``
        refusals pace this generator until the horizon is appended and
        every rank has drained the previous one (docs/STREAMING.md).
        Unbounded when ``horizons`` is None; yields stay exactly-once
        across faults, failover and mid-stream reshards exactly as one
        ``epoch_batches`` stream does.  A reshard that commits around a
        horizon boundary re-deals the horizon's pooled remainder over
        the NEW world — possibly to a rank that already finished it —
        so this loop re-enters the horizon whenever the generation moved
        under it (the post-commit array holds only the un-delivered
        share, making the re-entry exactly-once by construction)."""
        g = int(start_horizon)
        seq = int(start_seq)
        end = None if horizons is None else g + int(horizons)
        regen_retry = -1  # generation already backed up for, at most once
        while end is None or g < end:
            g_gen = self.generation
            try:
                yield from self.epoch_batches(g, start_seq=seq)
            except ServiceError as exc:
                if (exc.code == "horizon_advance" and g > 0
                        and self.generation != g_gen
                        and self.generation != regen_retry):
                    # a reshard was adopted while we waited to advance
                    # into g: the previous horizon's remainder was
                    # re-dealt and this rank may hold an unserved share
                    # — back up one horizon (the post-commit array is
                    # only the remainder, so the replay is exactly-once
                    # by construction), then retry the advance (once per
                    # generation, so a genuinely-stuck peer still
                    # surfaces the error).  A reshard epoch_batches rode
                    # through internally needs none of this: it already
                    # served the re-dealt share before returning.
                    regen_retry = self.generation
                    yield from self.epoch_batches(g - 1, start_seq=0)
                    seq = 0
                    continue
                raise
            seq = 0
            g += 1

    def capability_stream_batches(self, *, spec=None,
                                  start_horizon: int = 0,
                                  horizons: Optional[int] = None,
                                  start_seq: int = 0
                                  ) -> Iterator[np.ndarray]:
        """The zero-index-bytes epochless loop: one signed grant per
        horizon generation (its ``epoch`` IS the horizon gen, its
        ``stream_weights`` the horizon's effective mixture weights),
        regenerated on-device via :meth:`capability_epoch_batches`.  A
        horizon advance surfaces exactly like a membership change —
        ``capability_stale``-style re-fetch — and the typed streaming
        refusals pace the first grant of each new horizon
        (docs/STREAMING.md).  Horizon re-entry after a mid-stream
        reshard mirrors :meth:`stream_batches`: a moved generation means
        the remainder was re-dealt, so the horizon is replayed (the
        fresh grant regenerates only the rank's new share)."""
        g = int(start_horizon)
        seq = int(start_seq)
        end = None if horizons is None else g + int(horizons)
        regen_retry = -1
        while end is None or g < end:
            g_gen = self.generation
            try:
                yield from self.capability_epoch_batches(
                    g, spec=spec, start_seq=seq)
            except ServiceError as exc:
                if (exc.code == "horizon_advance" and g > 0
                        and self.generation != g_gen
                        and self.generation != regen_retry):
                    regen_retry = self.generation
                    yield from self.capability_epoch_batches(
                        g - 1, spec=spec, start_seq=0)
                    seq = 0
                    continue
                raise
            seq = 0
            g += 1

    # ---------------------------------------------------------- capability
    def _fetch_capability(self, epoch: int, spec) -> EpochCapability:
        """Obtain and verify the signed epoch capability for ``epoch``.

        ``capability_stale`` is the revocation surface: the typed
        retryable error already carries the FRESH membership and
        capability, so adopting them here costs no second round trip.
        ``capability_unsupported`` (a daemon running without a signing
        secret) surfaces as :class:`CapabilityError` — the loader's
        fallback ladder drops to the served-batch path on it
        (docs/CAPABILITY.md "Fallback ladder")."""
        req = {"rank": self.rank, "epoch": int(epoch),
               "gen": self.generation}
        try:
            reply, rheader, _ = self._rpc(P.MSG_GET_CAPABILITY, req)
        except ServiceError as exc:
            if exc.code == "capability_stale":
                self.metrics.inc("capability_stale", self.rank)
                self._adopt_membership(exc.header)
                wire = exc.header.get("capability")
                if wire is None:
                    raise CapabilityError(
                        "capability_stale reply carried no fresh "
                        "capability") from exc
                cap = EpochCapability.from_wire(wire)
                rheader = exc.header
            elif exc.code == "capability_unsupported":
                raise CapabilityError(
                    exc.header.get("detail")
                    or "server does not issue capabilities") from exc
            else:
                raise
        else:
            if reply != P.MSG_CAPABILITY:
                raise P.ProtocolError(
                    f"expected CAPABILITY, got {P.msg_name(reply)}")
            self._adopt_membership(rheader)
            cap = EpochCapability.from_wire(rheader["capability"])
        ts = rheader.get("target_samples")
        if ts is not None:
            # issued mid-drain: the reply names our drain watermark
            self._cap_drain = {"epoch": int(epoch),
                               "target_samples": int(ts)}
        # the slot's server-side acked cursor: a takeover of a
        # partly-served slot resumes regeneration AFTER it (the
        # capability-mode half of the double-delivery guard)
        self._cap_resume_seq = int(rheader.get("ack", -1)) + 1
        self._verify_capability(cap, int(epoch), spec)
        return cap

    def _verify_capability(self, cap: EpochCapability, epoch: int,
                           spec) -> None:
        """Client-side admission of a received capability: signature,
        spec fingerprint, tenant scope, epoch, generation.  ANY failure
        is a loud :class:`CapabilityError` (counted in
        ``capability_rejects``), never a silently-different stream."""
        rule = F.draw("capability.verify")
        if rule is not None:
            if rule.kind == "corrupt":
                # deterministic tamper: the HMAC check below must refuse
                cap = cap.tampered()
            else:
                try:
                    F.perform(rule)
                except F.InjectedThreadDeath:
                    raise
                except Exception as exc:
                    self.metrics.inc("capability_rejects", self.rank)
                    raise CapabilityError(
                        f"capability verification failed ({exc!r})"
                    ) from exc
        problem = None
        if self.capability_secret is None:
            problem = "client has no capability_secret to verify with"
        elif not self._cap_signature_ok(cap):
            problem = "HMAC signature check failed"
        elif spec is not None and \
                cap.fingerprint != spec.fingerprint(include_world=False):
            problem = (f"fingerprint {cap.fingerprint!r} is not this "
                       "job's spec")
        elif cap.tenant != self.tenant:
            problem = (f"grant is scoped to tenant {cap.tenant!r}, "
                       f"this client is bound to {self.tenant!r}")
        elif int(cap.epoch) != int(epoch):
            problem = f"grant is for epoch {cap.epoch}, not {epoch}"
        elif int(cap.generation) != int(self.generation):
            problem = (f"grant names generation {cap.generation}; the "
                       f"adopted membership is {self.generation}")
        if problem is not None:
            self.metrics.inc("capability_rejects", self.rank)
            raise CapabilityError(f"capability refused: {problem}")

    def _cap_signature_ok(self, cap: EpochCapability) -> bool:
        """Dispatch the HMAC check on the secret's shape: a federated
        ``TrustBundle``/``CellKeyring`` resolves ``(cap.cell, cap.kid)``
        to a per-cell key (an unknown cell or a retired kid raises the
        loud re-issue ``CapabilityError``); a plain secret verifies
        directly (docs/FEDERATION.md "Federated capabilities")."""
        secret = self.capability_secret
        if hasattr(secret, "secret_for"):
            from ..federation.keys import verify_capability
            return verify_capability(secret, cap)
        return cap.verify(secret)

    def capability_epoch_batches(self, epoch: int, *, spec=None,
                                 start_seq: int = 0
                                 ) -> Iterator[np.ndarray]:
        """Stream ``epoch``'s batches with ZERO index bytes on the wire
        (docs/CAPABILITY.md).

        One GET_CAPABILITY fetches the signed grant; after verification
        the stream is regenerated on-device with the same shared-law
        kernels the degraded fallback uses
        (:func:`~..capability.regen.membership_stream`), bit-identical
        to what ``epoch_batches`` would have served.  Only ack
        watermarks go back — flushed as HEARTBEATs whenever the locally
        delivered span would exceed the server's ``max_inflight`` window
        (the issuance slack floor covers exactly that span, so an
        elastic barrier can never freeze BEHIND what we delivered) and
        at least every ``capability_heartbeat_s`` as the batchless
        keepalive.

        Rides through reshards like the served path: a heartbeat that
        returns a bumped generation (or a ``cap_drain`` drain notice)
        makes the generator deliver exactly to the frozen watermark,
        flush the gate-satisfying ack, re-fetch through the
        ``capability_stale`` flow, and continue with the post-reshard
        remainder — one contiguous exactly-once stream.  Ends early
        (``membership_lost``) only when the shrunken world has no slot
        for this rank."""
        spec = spec if spec is not None else self.expected_spec
        if spec is None:
            raise CapabilityError(
                "capability mode needs the stream-shaping spec: pass "
                "spec= here or construct the client with one")
        epoch, seq = int(epoch), int(start_seq)
        if self._samples_epoch != epoch:
            # new epoch: the trail describes the previous epoch's
            # deliveries — start fresh (same law as epoch_batches)
            self._trail = []
            self._epoch_samples = 0
            self._samples_epoch = epoch
        self._cursor = {"epoch": epoch, "seq": seq}
        self._ensure_connected()
        cap = self._fetch_capability(epoch, spec)
        # a partly-served slot (takeover of a vacated rank) resumes
        # after the server-side acked watermark the grant reported
        seq = max(seq, self._cap_resume_seq)
        self._cursor = {"epoch": epoch, "seq": seq}
        acked = seq - 1              # watermark last flushed server-side
        last_hb = self._clock()
        while True:                  # one iteration per membership
            if not (self.rank is not None and self.world is not None
                    and int(self.rank) < int(self.world)):
                # shrunk out: our share of the epoch belongs to others
                self.metrics.inc("membership_lost")
                return
            mi = self._server_max_inflight or self.lookahead
            layers = self.layers if (
                self.elastic_epoch is not None
                and int(self.elastic_epoch) == epoch) else []
            sw = getattr(cap, "stream_weights", None)
            regen_spec = spec
            if sw is not None and hasattr(spec, "with_stream_weights"):
                # moving-horizon mixture stream: the signed grant carries
                # the horizon's EFFECTIVE weights (base + every delta
                # folded at advances <= epoch), so on-device regen folds
                # the re-weighted horizon bit-identically to the served
                # path (docs/STREAMING.md "Weight-update protocol")
                regen_spec = spec.with_stream_weights({epoch: tuple(sw)})
            arr = membership_stream(regen_spec, epoch, self.rank,
                                    self.world, layers, self.orphans)
            total = int(arr.shape[0])
            refetch = False
            while not refetch:
                cd = self._cap_drain
                target = None
                if cd is not None and int(cd.get("epoch", -1)) == epoch:
                    target = int(cd["target_samples"])
                stop = total if target is None else min(total, target)
                lo = seq * self.batch
                if lo >= stop:
                    # delivered everything this membership owes — the
                    # epoch tail, or the frozen drain watermark.  Flush
                    # the terminal ack NOW (a lazy piggyback could
                    # deadlock a barrier gated on it), then finish or
                    # wait out the commit.
                    g = self.heartbeat()
                    acked, last_hb = seq - 1, self._clock()
                    if int(g) == int(cap.generation) \
                            and self.generation == cap.generation:
                        if target is None:
                            return
                        # drain-wait: the barrier needs other ranks too
                        time.sleep(min(0.05, self.backoff_base))
                        continue
                    cap = self._fetch_capability(epoch, spec)
                    seq = self._cap_resume_seq
                    acked = seq - 1
                    self._cursor = {"epoch": epoch, "seq": seq}
                    refetch = True
                    continue
                if seq - acked > mi or (self._clock() - last_hb
                                        >= self.capability_heartbeat_s):
                    # client half of the slack law / batchless keepalive
                    g = self.heartbeat()
                    acked, last_hb = seq - 1, self._clock()
                    if int(g) != int(cap.generation) \
                            or self.generation != cap.generation:
                        # revoked mid-stream; by the slack law our
                        # delivered watermark is <= the frozen target,
                        # so the trail entry the stale flow records is
                        # exactly the prefix the cascade preserved
                        cap = self._fetch_capability(epoch, spec)
                        seq = self._cap_resume_seq
                        acked = seq - 1
                        self._cursor = {"epoch": epoch, "seq": seq}
                        refetch = True
                    # re-enter the loop either way: the reply may have
                    # carried a ``cap_drain`` notice, and delivering the
                    # next batch against the pre-heartbeat ``stop``
                    # would run past a freshly frozen drain watermark
                    continue
                hi = min(lo + self.batch, stop)
                batch_arr = arr[lo:hi]
                # advance BEFORE yielding: once the consumer holds the
                # batch it counts as delivered (exactly-once on resume)
                seq += 1
                self._cursor = {"epoch": epoch, "seq": seq}
                self._epoch_samples = max(self._epoch_samples, int(hi))
                yield batch_arr

    def capability_epoch_indices(self, epoch: int, *,
                                 spec=None) -> np.ndarray:
        """The rank's full epoch stream via the capability path — the
        drop-in for ``epoch_indices`` when both sides share a
        ``capability_secret``."""
        parts = list(self.capability_epoch_batches(epoch, spec=spec))
        if not parts:
            return np.empty(0, dtype=np.int64)
        return np.concatenate(parts)

    def local_epoch_indices(self, spec, epoch: int) -> np.ndarray:
        """Compose this client's epoch stream LOCALLY from its adopted
        membership — the degraded-mode fallback's source of truth.

        For a non-elastic epoch this is simply the rank's stream under
        the current membership.  For the elastic epoch it is the exact
        trail of memberships this client delivered under: each
        ridden-through generation contributes the prefix it actually
        served (its recorded watermark), and the current membership
        contributes its full remainder stream — together bit-identical
        to what the service would have gone on to serve.  ``spec`` is
        the stream-shaping spec (any world; each membership entry
        re-bases it via ``with_world``).

        The composition law itself lives in
        :func:`~..capability.regen.replay_trail` — ONE implementation
        shared with capability-mode regeneration, so the two local
        paths cannot drift."""
        epoch = int(epoch)
        return replay_trail(
            spec, epoch, rank=self.rank, world=self.world,
            layers=self.layers, orphans=self.orphans,
            elastic_epoch=self.elastic_epoch,
            trail=self._trail if self._samples_epoch == epoch else (),
        )

    @staticmethod
    def _orphan_slice(spec, o: dict) -> np.ndarray:
        """Materialise one orphan descriptor against ``spec`` — the same
        law the server applies when serving rank 0's prefix (delegates
        to the shared :func:`~..capability.regen.orphan_slice`)."""
        return orphan_slice(spec, o)

    # ---------------------------------------------------------- checkpoint
    def state_dict(self) -> dict:
        """The resume cursor: drop it into ``utils/checkpoint`` alongside
        the trainer state to continue a killed *client* exactly-once."""
        return {"kind": "service_client", "rank": self.rank,
                "epoch": self._cursor["epoch"], "seq": self._cursor["seq"]}

    def load_state_dict(self, state: dict) -> None:
        if state.get("kind") != "service_client":
            raise ValueError(
                f"state kind {state.get('kind')!r} is not a service_client "
                "checkpoint"
            )
        self.rank = None if state["rank"] is None else int(state["rank"])
        self._cursor = {"epoch": state["epoch"], "seq": int(state["seq"])}

    def resume_batches(self) -> Iterator[np.ndarray]:
        """Continue the loaded/current cursor's epoch from where it left."""
        if self._cursor["epoch"] is None:
            raise RuntimeError("no cursor to resume; call epoch_batches or "
                               "load_state_dict first")
        return self.epoch_batches(self._cursor["epoch"],
                                  start_seq=self._cursor["seq"])
