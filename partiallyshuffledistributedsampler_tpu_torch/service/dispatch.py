"""Shared listener plumbing: one accept/dispatch loop, many daemons.

:class:`DispatchListener` is the per-connection accept/serve machinery
extracted from ``IndexServer`` so the rank-space :class:`~..sharding.ShardRouter`
and the shard servers run the *same* framing/CRC/trace code path instead
of a third copy (docs/SHARDING.md).  The mixin owns exactly the
transport-facing loop — bind, accept, spawn a serve thread per
connection, frame in, dispatch, frame out — and delegates everything
policy-shaped through small hooks:

* ``_dispatch(sock, conn_id, msg, header, payload)`` — the one required
  override: route a decoded frame to a handler.
* ``_on_accept_tick()`` — the 0.2 s accept timeout tick (``IndexServer``
  runs its lease/membership sweeps here).
* ``_conn_engine(conn_id)`` / ``_span_extra(eng)`` — who owns the
  request (tenant routing) and what extra attributes its telemetry span
  carries.
* ``_observe_dispatch(eng, msg, t0)`` — post-dispatch timing
  (``batch_service_ms`` on the index server).
* ``_conn_cleanup(conn_id)`` — connection teardown (lease release).

Host classes must provide ``host``/``port``, ``_stop`` (Event),
``_lock``, ``_listener``, ``_threads``, ``_conn_socks`` and
``_next_conn_id``.  The loop bytes are unchanged from the pre-extraction
``IndexServer`` — frames on the wire are bit-identical.
"""

from __future__ import annotations

import socket
import threading
import time

from .. import faults as F
from .. import telemetry
from ..telemetry import span as _span
from . import protocol as P


class DispatchListener:
    """Accept-loop + per-connection dispatch mixin (transport only)."""

    #: thread names; subclasses override for operator-legible dumps
    _ACCEPT_THREAD_NAME = "psds-service-accept"
    _CONN_THREAD_PREFIX = "psds-service-conn"
    #: telemetry span prefix for dispatched frames
    _SPAN_PREFIX = "server."

    # ------------------------------------------------------------ listener
    def _listener_bind(self) -> tuple:
        """Bind ``(self.host, self.port)``, start the accept thread, and
        return the bound address (``port=0`` resolves to an ephemeral
        port)."""
        ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        ls.bind((self.host, self.port))
        ls.listen(128)
        ls.settimeout(0.2)  # the accept loop doubles as the sweep tick
        self.host, self.port = ls.getsockname()[:2]
        self._listener = ls
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name=self._ACCEPT_THREAD_NAME)
        t.start()
        self._threads.append(t)
        return self.host, self.port

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            ls = self._listener
            if ls is None:
                return
            try:
                sock, _addr = ls.accept()
            except socket.timeout:
                self._on_accept_tick()
                continue
            except OSError:
                return  # listener closed by stop()
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                conn_id = self._next_conn_id
                self._next_conn_id += 1
                self._conn_socks[conn_id] = sock
            t = threading.Thread(
                target=self._serve_conn, args=(sock, conn_id), daemon=True,
                name=f"{self._CONN_THREAD_PREFIX}-{conn_id}",
            )
            t.start()
            # prune finished serve threads while appending: a long-lived
            # daemon churning reconnects must not accumulate dead Thread
            # objects (and stop() must not re-join them)
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    # ------------------------------------------------------- per-connection
    def _serve_conn(self, sock: socket.socket, conn_id: int) -> None:
        try:
            while not self._stop.is_set():
                try:
                    msg, header, payload = P.recv_msg(sock)
                except P.ProtocolError as exc:
                    # best-effort complaint, then drop the broken peer
                    try:
                        P.send_msg(sock, P.MSG_ERROR,
                                   {"code": "protocol", "detail": str(exc)})
                    except OSError:
                        pass
                    return
                t0 = time.perf_counter()
                eng = self._conn_engine(conn_id)
                try:
                    if telemetry.enabled():
                        # the span wraps the fault-injection point too,
                        # so a dump triggered by an injected dispatch
                        # fault shows the request being served when it
                        # fired
                        with _span(self._SPAN_PREFIX + P.msg_name(msg),
                                   trace=header.get("trace"), conn=conn_id,
                                   rank=header.get("rank"),
                                   **self._span_extra(eng)):
                            F.fire("server.dispatch")
                            self._dispatch(sock, conn_id, msg, header,
                                           payload)
                    else:
                        # tracing off: no span, no kwargs dict, no name
                        # concat on the per-request hot path
                        F.fire("server.dispatch")
                        self._dispatch(sock, conn_id, msg, header, payload)
                except OSError:
                    return  # peer vanished mid-reply
                self._observe_dispatch(eng, msg, t0)
        except (ConnectionError, OSError):
            return
        except F.InjectedThreadDeath:
            return  # injected serve-thread death; cleanup below still runs
        finally:
            self._conn_cleanup(conn_id)
            try:
                sock.close()
            except OSError:
                pass

    # ----------------------------------------------------------------- hooks
    def _dispatch(self, sock, conn_id, msg, header, payload) -> None:
        raise NotImplementedError

    def _on_accept_tick(self) -> None:
        """Called on every accept-timeout tick (~0.2 s)."""

    def _conn_engine(self, conn_id: int):
        """The engine owning this connection's requests (tenant routing)."""
        return self

    def _span_extra(self, eng) -> dict:
        """Extra telemetry-span attributes for a dispatched frame."""
        return {}

    def _observe_dispatch(self, eng, msg, t0: float) -> None:
        """Post-dispatch timing hook (``t0`` is a ``perf_counter``)."""

    def _conn_cleanup(self, conn_id: int) -> None:
        """Teardown when a serve thread exits (crash or close)."""
        self._release_conn(conn_id)

    def _release_conn(self, conn_id: int) -> None:
        with self._lock:
            self._conn_socks.pop(conn_id, None)
