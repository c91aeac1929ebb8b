"""Wire protocol of the index service: length-prefixed binary framing.

One frame on the wire is

    u32  length of everything after this field (big-endian)
    u8   message type (the MSG_* constants)
    u32  header length H (big-endian)
    H bytes of UTF-8 JSON header
    remaining bytes: raw payload (index batches ride here as native
                     numpy bytes; ``header["dtype"]`` names the layout)

The header carries the small structured fields (rank, epoch, seq, error
codes); the payload is reserved for bulk index data so a batch costs one
JSON parse of a ~100-byte header, never a JSON encode of the indices.
BATCH headers additionally carry ``crc32`` over the payload; a receiver
that sees a mismatch raises :class:`ChecksumError` and (being idempotent)
simply re-requests the same seq.

Versioning: ``HELLO`` carries ``proto=PROTOCOL_VERSION``; the peers
negotiate it explicitly — a mismatch draws a typed
``ERROR(code='protocol_version')`` carrying both version ints, so an old
client fails at the handshake with an actionable error instead of
undefined frame decoding mid-epoch.  Message types are stable small ints
— new types may be added within a version; unknown types draw an
``ERROR`` reply, not a closed connection.  Version 2 added the elastic
membership messages (``LEAVE``/``RESHARD``), generation-stamped
``GET_BATCH``, and the v2 snapshot schema (docs/SERVICE.md).

Request → reply pairs (client sends left, server answers right):

    HELLO      → WELCOME | ERROR     claim a rank (``rank=-1`` auto-claims)
    GET_BATCH  → BATCH | ERROR       one batch of the rank's epoch stream
    SET_EPOCH  → OK | ERROR          advance the served epoch
    SNAPSHOT   → SNAPSHOT_STATE      server state (restart/restore dict)
    HEARTBEAT  → OK                  keep the rank lease alive
    METRICS    → METRICS_REPORT      the daemon's counters/timers
    LEAVE      → OK | ERROR          preemption-notice drain: trigger a
                                     reshard to world-1 and drain out
    RESHARD    → OK | ERROR          explicit mid-epoch world change
    TRACE_DUMP → TRACE_REPORT        recent telemetry entries (the
                                     flight-recorder ring, bounded by
                                     ``limit``; docs/OBSERVABILITY.md)

Replication frames (docs/RESILIENCE.md "Replication & failover"; the
primary's shipper sends left, the standby answers right):

    REPL_SYNC    → OK | ERROR        bootstrap: term + lsn + the full
                                     snapshot-v2 state dict
    REPL_APPEND  → OK | ERROR        a run of sequenced WAL records
                                     (``ERROR(code='repl_gap')`` asks
                                     for a re-SYNC; ``fenced`` tells a
                                     zombie primary it was superseded)
    REPL_PROMOTE → OK | ERROR        promote the standby to primary
                                     (refused ``standby`` while its
                                     replication feed is still fresh,
                                     unless ``force`` is set)

Elastic error codes (docs/RESILIENCE.md "Elastic membership"):
``reshard`` (barrier in progress — retry shortly), ``resharded`` (the
request named a stale generation; the header carries the new
``generation``/``world``/``layers`` membership to adopt).

Replication error codes (docs/RESILIENCE.md "Replication & failover"):
``standby`` (this server is a hot standby; the header carries the
``primary`` address and the current ``term`` — data ops are refused
until a promotion), ``fenced`` (the request's fencing term lost: the
header carries the winning ``term`` and ``serving`` — True when THIS
server keeps serving at that term and the caller should adopt it and
retry, False when this server is a fenced zombie and the caller must
fail over), ``repl_gap`` (an append's ``from_lsn`` does not extend the
standby's applied prefix; the shipper re-SYNCs).

Tenancy fields and codes (docs/SERVICE.md "Tenancy"): ``HELLO`` MAY
carry the full wire ``spec`` alongside ``spec_fingerprint`` — a
multi-tenant daemon uses it to *create* the job's namespace on first
contact; a single-tenant daemon ignores it.  ``WELCOME`` carries the
assigned ``tenant`` id, and any request header MAY stamp ``tenant`` to
name its namespace explicitly (a reconnect that lost its HELLO binding).
Both ride inside protocol version 2 the same way ``trace`` does —
additive header fields, ignored by peers that predate them.  Error
codes: ``spec_mismatch`` (terminal — the fingerprints disagree and no
tenant can be attached; the header carries both ``server_fingerprint``
and ``client_fingerprint``, plus ``tenants``/``max_tenants`` when the
refusal was a capacity limit), ``tenant_admission`` (retryable — a
per-tenant quota refused the HELLO; the header carries ``retry_ms``).

Sharding fields and codes (docs/SHARDING.md): a ``ShardRouter``'s
``WELCOME`` carries ``router=true`` plus the deployment's ``shard_map``
(``{version, world, shards:[{id, ranks:[lo,hi), addr}], fingerprint}``)
and assigns no rank — the client direct-connects the owning shard; a
shard's ``WELCOME`` rides ``shard`` and the same ``shard_map``.  ``HELLO``
MAY carry ``attach=true`` to admit/create a tenant namespace WITHOUT
claiming a rank lease (answered ``OK`` with the ``tenant`` id).
``RESHARD`` MAY carry ``phase`` (``prepare`` | ``commit`` | ``abort``)
for the router's two-phase cross-shard barrier — ``commit`` imposes the
global ``barrier_units``, the post-barrier ``map``, and ``dead_ranks``
(sent only to the shard owning rank 0, which serves the orphan prefix).
All are additive header fields inside protocol version 2.  Error codes:
``wrong_shard`` (retryable — the dialed shard does not own the rank; the
header carries ``retry_ms``, ``owner`` and a fresh ``shard_map`` so the
client re-routes without a router round-trip), ``router_route`` (an
injected route fault; retryable), ``shard_barrier`` (a cross-shard
fan-out did not complete; retryable — barrier requests are idempotent).

Capability frames (docs/CAPABILITY.md — serve seeds, not indices):

    GET_CAPABILITY → CAPABILITY | ERROR   a signed epoch capability: the
                                          world-stripped spec fingerprint,
                                          epoch seed, membership generation
                                          + cascade ``layers``, tenant, and
                                          an HMAC over the canonical
                                          encoding.  The reply carries the
                                          current membership, the slot's
                                          server-side ``ack`` cursor (a
                                          takeover of a partly-served
                                          slot resumes regeneration at
                                          ``ack + 1``, never seq 0) and,
                                          when a drain barrier is already
                                          in flight for the rank, its
                                          ``target_samples`` clamp.

A capability-mode client sends only ``HEARTBEAT`` frames with the
``hb=[epoch, ack]`` piggyback while it regenerates indices on-device;
the ``OK`` reply MAY carry ``cap_drain={"epoch", "target_samples"}`` to
tell a batchless stream its drain clamp (an additive header field;
served-batch clients never see it).  Error codes: ``capability_stale``
(retryable — the request named a revoked generation; the header carries
a fresh ``capability`` plus the new membership to adopt),
``capability_issue`` (retryable — an injected/transient issuance fault),
``capability_unsupported`` (terminal — the daemon has no signing secret
configured; use the served-batch path).  Both frame types are additive
within protocol version 2: a deployment that never requests a
capability puts zero extra bytes on the wire.

Streaming frames (docs/STREAMING.md — epochless moving-horizon shuffle):

    APPEND → OK | ERROR              a feeder extends the append-only
                                     index space by ``count`` samples;
                                     idempotent under retry via the
                                     monotonic ``stream_seq`` per
                                     ``feeder`` id, MAY carry an
                                     additive per-source
                                     ``weights_delta`` folded into the
                                     mixture weights at the next
                                     horizon advance.  The ``OK`` reply
                                     carries ``appended``, ``eligible``
                                     (fully-appended horizons) and the
                                     stream's current horizon ``epoch``.

On a stream-mode spec the epoch number of ``GET_BATCH`` /
``GET_CAPABILITY`` *is* the horizon generation; the server gates it with
typed retryable refusals: ``horizon_pending`` (the horizon is not fully
appended yet — the header carries ``appended``/``eligible`` and
``retry_ms``), ``horizon_advance`` (the ack-gated advance barrier is
waiting on straggler ranks, or an injected ``stream.advance`` fault
aborted the advance before any state moved — retry and the barrier
resolves), ``stream_append`` (an injected/transient ``stream.append``
fault refused the APPEND; retryable — the ``stream_seq`` makes the
retry exact-once).  All are additive within protocol version 2: a
frozen-dataset deployment never sees them.

Tracing: any request header MAY carry ``trace=[trace_id, span_id]`` —
the sender's open span context (docs/OBSERVABILITY.md).  Receivers that
know about it parent their dispatch span under it; receivers that don't
ignore it like any unknown header field, so the field rides inside
protocol version 2 without a bump.  A disabled tracer never adds the
field, so tracing-off peers put zero extra bytes on the wire.
"""

from __future__ import annotations

import json
import socket
import struct
import zlib

import numpy as np

from .. import faults as F

#: bump on any framing/semantics change; HELLO negotiates it.
#: v2: LEAVE/RESHARD messages, generation-stamped GET_BATCH, snapshot v2.
#: Additive-within-v2 (no bump needed): TRACE_DUMP/TRACE_REPORT message
#: types and the optional ``trace`` request-header field.
PROTOCOL_VERSION = 2

#: frames above this are a protocol violation (a corrupt length prefix
#: must not make the reader try to allocate gigabytes)
MAX_FRAME = 1 << 26  # 64 MiB

MSG_HELLO = 1
MSG_WELCOME = 2
MSG_GET_BATCH = 3
MSG_BATCH = 4
MSG_SET_EPOCH = 5
MSG_SNAPSHOT = 6
MSG_SNAPSHOT_STATE = 7
MSG_HEARTBEAT = 8
MSG_OK = 9
MSG_ERROR = 10
MSG_METRICS = 11
MSG_METRICS_REPORT = 12
MSG_LEAVE = 13
MSG_RESHARD = 14
MSG_TRACE_DUMP = 15
MSG_TRACE_REPORT = 16
# additive-within-v2 (like TRACE_DUMP): hot-standby replication frames
MSG_REPL_SYNC = 17
MSG_REPL_APPEND = 18
MSG_REPL_PROMOTE = 19
# additive-within-v2: signed epoch capabilities (docs/CAPABILITY.md) —
# a client that never sends GET_CAPABILITY pays zero protocol overhead
MSG_GET_CAPABILITY = 20
MSG_CAPABILITY = 21
# additive-within-v2: the moving-horizon stream's feeder frame
# (docs/STREAMING.md) — a frozen-dataset deployment never sends it
MSG_APPEND = 22

_NAMES = {
    v: k[len("MSG_"):] for k, v in list(globals().items())
    if k.startswith("MSG_")
}


def msg_name(msg_type: int) -> str:
    return _NAMES.get(msg_type, f"UNKNOWN({msg_type})")


class ProtocolError(RuntimeError):
    """Malformed frame or out-of-contract message sequence."""


class ChecksumError(ProtocolError):
    """BATCH payload failed its CRC32 — the frame arrived torn/corrupted.

    Unlike other protocol errors this one is *recoverable by re-request*
    (the server's reply is a pure function of ``(epoch, seq)``), so the
    client rejects the batch and asks for the same seq again instead of
    tearing the connection down."""


def pack(msg_type: int, header: dict, payload: bytes = b"") -> bytes:
    h = json.dumps(header, separators=(",", ":")).encode()
    body_len = 1 + 4 + len(h) + len(payload)
    if body_len > MAX_FRAME:
        raise ProtocolError(f"frame of {body_len} bytes exceeds {MAX_FRAME}")
    return struct.pack("!IBI", body_len, msg_type, len(h)) + h + payload


def send_msg(sock: socket.socket, msg_type: int, header: dict,
             payload: bytes = b"", *, site: str = None) -> None:
    """Frame and send one message.  ``site`` names a fault-injection
    point (docs/RESILIENCE.md): under an armed plan the framed bytes may
    be delayed, torn mid-frame, corrupted, or replaced by a reset."""
    frame = pack(msg_type, header, payload)
    if site is not None:
        rule = F.draw(site)
        if rule is not None:
            frame = F.apply_to_frame(rule, sock, frame)
    sock.sendall(frame)


def send_msgs(sock: socket.socket, msgs, *, site: str = None) -> None:
    """Frame several messages and send them as ONE coalesced buffer
    (writev-style) — one syscall instead of one per request, which is
    what lets the pipelined client top up its lookahead window without
    multiplying per-step wire ops.

    ``msgs`` is an iterable of ``(msg_type, header)`` or ``(msg_type,
    header, payload)`` tuples, each packed exactly as :func:`send_msg`
    packs it, so the receiver cannot tell coalesced frames from
    individual sends.  A single fault draw applies to the *combined*
    buffer: a ``torn_frame``/``reset`` rule tears mid-stream across
    message boundaries — exactly the failure a pipelined sender must
    survive with its acks intact.
    """
    parts = []
    for m in msgs:
        payload = m[2] if len(m) > 2 else b""
        parts.append(pack(m[0], m[1], payload))
    frame = b"".join(parts)
    if site is not None:
        rule = F.draw(site)
        if rule is not None:
            frame = F.apply_to_frame(rule, sock, frame)
    sock.sendall(frame)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-frame"
                                  if buf or n else "peer closed")
        buf += chunk
    return bytes(buf)


def recv_msg(sock: socket.socket, *, site: str = None):
    """Read one frame → ``(msg_type, header, payload)``.

    Raises ``ConnectionError`` on a clean or mid-frame close (the retry
    layer's signal to reconnect) and :class:`ProtocolError` on a frame
    that cannot be parsed (never retried — the peer is broken).  ``site``
    names a fault-injection point: reset/delay fire before the read,
    ``corrupt`` flips a byte of the received payload (which the CRC32
    check in :func:`decode_indices` must then catch)."""
    rule = F.draw(site) if site is not None else None
    if rule is not None and rule.kind != "corrupt":
        F.perform(rule)
    (body_len,) = struct.unpack("!I", _recv_exact(sock, 4))
    if not 5 <= body_len <= MAX_FRAME:
        raise ProtocolError(f"frame length {body_len} outside [5, {MAX_FRAME}]")
    body = _recv_exact(sock, body_len)
    msg_type, hlen = struct.unpack("!BI", body[:5])
    if hlen > body_len - 5:
        raise ProtocolError(f"header length {hlen} overruns frame {body_len}")
    try:
        header = json.loads(body[5:5 + hlen].decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise ProtocolError(f"unparseable header: {exc}") from None
    if not isinstance(header, dict):
        raise ProtocolError(f"header must be a JSON object, got "
                            f"{type(header).__name__}")
    payload = body[5 + hlen:]
    if rule is not None and rule.kind == "corrupt":
        payload = F.flip_byte(payload)
    return msg_type, header, payload


# ------------------------------------------------------- index batch codec
def encode_indices(arr: np.ndarray):
    """``(header_fields, payload)`` for an index batch: raw bytes plus the
    dtype string (with byte order) the receiver rebuilds from, and a
    CRC32 of the payload so a torn/corrupted frame that survives framing
    cannot become silently wrong indices."""
    a = np.ascontiguousarray(arr)
    payload = a.tobytes()
    return {"dtype": a.dtype.str, "count": int(a.shape[0]),
            "crc32": zlib.crc32(payload) & 0xFFFFFFFF}, payload


def decode_indices(header: dict, payload: bytes) -> np.ndarray:
    try:
        dtype = np.dtype(header["dtype"])
    except (KeyError, TypeError, ValueError) as exc:
        raise ProtocolError(f"bad BATCH dtype: {exc}") from None
    count = int(header.get("count", -1))
    if dtype.itemsize * max(count, 0) != len(payload):
        raise ProtocolError(
            f"BATCH payload is {len(payload)} bytes; header promises "
            f"{count} x {dtype}"
        )
    crc = header.get("crc32")
    if crc is not None and (zlib.crc32(payload) & 0xFFFFFFFF) != int(crc):
        # absent crc32 is tolerated (pre-checksum peers within the same
        # protocol version); a PRESENT mismatch is a corrupted payload
        raise ChecksumError(
            f"BATCH payload crc32 mismatch (header {int(crc)}); "
            "rejecting the corrupted frame"
        )
    arr = np.frombuffer(payload, dtype=dtype)
    arr.setflags(write=False)  # frombuffer views are read-only anyway
    return arr
