"""Span tracer: monotonic-clock host tracing, placed on the profiler's clock.

A :class:`Span` is one timed operation — name, trace/span/parent ids,
attributes set as they become known, point-in-time events.  Spans nest
through a per-thread stack, so a child opened anywhere under an open
span links to it automatically; *remote* parents (the optional ``trace``
field a service frame header carries) link the same way, which is how
one trace id follows a request from ``ServiceIndexClient._rpc`` through
``IndexServer`` dispatch, regen, a reshard refusal, and back out the
retry (docs/OBSERVABILITY.md).

Zero-cost-when-off is the design constraint: a disabled
:class:`Tracer` hands out the one shared :data:`NULL_SPAN`, whose every
method is a no-op and whose ``ids`` is ``None`` — the hot path pays one
attribute check and no allocation, and a ``None`` context means no
``trace`` field is added to any protocol frame.

An exception that crosses a span boundary is tagged with the innermost
span's ids (``exc._psds_span``), so a caller catching it later can link
follow-up work — the degraded-fallback regen span in
``HostDataLoader`` links to the exact RPC span that failed this way.

A finished span's entry carries ``start_ns``, its start on the Unix-epoch
clock that ``torch.profiler`` (Kineto) stamps its events with, so a span
can be laid over a device trace; its duration ``ms`` stays on the
monotonic clock.  A span opened with ``device_ms=<a CUDA device>`` also
records a pair of timing events on that device's current stream at enter
and exit; the entry's ``device_ms`` (their elapsed time) is resolved when
the ring is read (:func:`resolve`), never inside the span.  While a
profiler records, every span (and :func:`profiler_range`) enters a
``torch.profiler.record_function`` range of its name, traced or not;
while none records, no range is entered.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Optional

import torch

from ..analysis.lockorder import new_lock

#: attrs/event payloads are redacted to small JSON-safe values at record
#: time — a span can never smuggle index payloads into a dump
_MAX_STR = 256
_MAX_ITEMS = 16

_rng = random.Random()  # urandom-seeded; getrandbits is atomic under the GIL


def _scrub(v, depth: int = 0):
    """JSON-safe redaction of one attribute value (ids/attrs only, never
    bulk data: strings truncate, containers cap at 16 items, anything
    else degrades to a truncated repr)."""
    if v is None or isinstance(v, (bool, int, float)):
        return v
    if isinstance(v, str):
        return v if len(v) <= _MAX_STR else v[:_MAX_STR] + "..."
    if depth < 2 and isinstance(v, (list, tuple)):
        return [_scrub(x, depth + 1) for x in v[:_MAX_ITEMS]]
    if depth < 2 and isinstance(v, dict):
        return {str(k)[:64]: _scrub(x, depth + 1)
                for k, x in list(v.items())[:_MAX_ITEMS]}
    r = repr(v)
    return r if len(r) <= _MAX_STR else r[:_MAX_STR] + "..."


class _NullSpan:
    """The shared no-op span a disabled tracer returns: every method
    swallows its arguments, ``ids`` is None (nothing to put on the
    wire), and entering/exiting touches no state."""

    __slots__ = ()

    ids = None
    trace_id = None
    span_id = None

    def set(self, _key, _value) -> "_NullSpan":
        return self

    def event(self, _name, **_attrs) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NULL_SPAN = _NullSpan()

#: true while a ``torch.profiler`` (or autograd profiler) session records
profiling = torch.autograd._profiler_enabled


class _ProfilerRange(_NullSpan):
    """What a disabled tracer returns while a profiler records: the no-op
    span's API around a ``record_function`` range of the span's name."""

    __slots__ = ("_rf",)

    def __init__(self, name: str) -> None:
        self._rf = torch.profiler.record_function(name)

    def __enter__(self) -> "_ProfilerRange":
        self._rf.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self._rf.__exit__(*exc)
        return False


def profiler_range(name: str):
    """A ``record_function`` range of ``name`` while a profiler records,
    else the shared no-op span: the profiler annotation of a site that
    has no span."""
    return _ProfilerRange(name) if profiling() else NULL_SPAN


class _DeviceInterval:
    """Two timing events recorded on a CUDA stream around a span; read
    (waiting for the later one) only by :func:`resolve`."""

    __slots__ = ("start", "end", "stream")

    def __init__(self, device) -> None:
        self.stream = torch.cuda.current_stream(device)
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)
        self.start.record(self.stream)

    def done(self) -> bool:
        return self.end.query()

    def ms(self) -> float:
        self.end.synchronize()
        return float(self.start.elapsed_time(self.end))


def resolve(entry: dict, wait: bool = True) -> dict:
    """``entry`` with its pending device interval replaced by the elapsed
    device ms (in place).  ``wait=False`` leaves an interval the device
    has not reached yet pending; ``wait=True`` waits for it."""
    iv = entry.get("device_ms")
    if isinstance(iv, _DeviceInterval) and (wait or iv.done()):
        entry["device_ms"] = iv.ms()
    return entry


def jsonable(value):
    """``json.dumps``'s fallback for an entry's values: a device interval
    not read yet writes as null, anything else as its repr."""
    return None if isinstance(value, _DeviceInterval) else repr(value)


def pending(entry: dict) -> bool:
    """True while ``entry``'s device interval is not reached yet."""
    iv = entry.get("device_ms")
    return isinstance(iv, _DeviceInterval) and not iv.done()


def _cuda(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


class Span:
    """One timed operation in a trace.

    Use as a context manager (via :meth:`Tracer.span`); on exit the
    duration is computed from the tracer's monotonic clock, an in-flight
    exception marks ``status='error'`` (and tags the exception with this
    span's ids unless an inner span already did), and the finished entry
    is appended to the tracer's recorder.  ``device`` (a CUDA device or
    None) asks for the span's device interval."""

    __slots__ = ("tracer", "name", "trace_id", "span_id", "parent_id",
                 "attrs", "events", "t0", "ms", "status", "error",
                 "thread", "start_ns", "device", "_interval", "_rf")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 span_id: str, parent_id: Optional[str],
                 attrs: dict, device=None) -> None:
        self.tracer = tracer
        self.name = str(name)
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.attrs = attrs
        self.events: list[dict] = []
        self.t0 = 0.0
        self.ms: Optional[float] = None
        self.status = "ok"
        self.error: Optional[str] = None
        self.thread = threading.current_thread().name
        self.start_ns: Optional[int] = None
        self.device = device
        self._interval: Optional[_DeviceInterval] = None
        self._rf = None

    @property
    def ids(self) -> list:
        """The wire form of this span's context: ``[trace_id, span_id]``
        — what a protocol header's ``trace`` field carries."""
        return [self.trace_id, self.span_id]

    def set(self, key: str, value) -> "Span":
        self.attrs[str(key)] = _scrub(value)
        return self

    def event(self, name: str, **attrs) -> "Span":
        self.events.append({
            "name": str(name),
            "ms": round((self.tracer._clock() - self.t0) * 1e3, 3),
            "attrs": {k: _scrub(v) for k, v in attrs.items()},
        })
        return self

    def entry(self, *, open: bool = False) -> dict:
        e = {
            "kind": "span", "name": self.name, "trace": self.trace_id,
            "span": self.span_id, "parent": self.parent_id,
            "ms": self.ms, "status": self.status, "thread": self.thread,
            "attrs": dict(self.attrs), "events": list(self.events),
            "start_ns": self.start_ns,
            "device_ms": None if open else self._interval,
        }
        if self.error is not None:
            e["error"] = self.error
        if open:
            e["open"] = True
            e["ms"] = round((self.tracer._clock() - self.t0) * 1e3, 3)
        return e

    def __enter__(self) -> "Span":
        if profiling():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        if self.device is not None:
            self._interval = _DeviceInterval(self.device)
        # the profiler's clock, not the injectable one: Kineto stamps its
        # events in Unix-epoch nanoseconds
        self.start_ns = time.time_ns()
        self.t0 = self.tracer._clock()
        self.tracer._push(self)
        return self

    def __exit__(self, exc_type, exc, _tb) -> bool:
        self.ms = round((self.tracer._clock() - self.t0) * 1e3, 3)
        if self._interval is not None:
            self._interval.end.record(self._interval.stream)
        if self._rf is not None:
            self._rf.__exit__(exc_type, exc, _tb)
            self._rf = None
        if exc is not None:
            self.status = "error"
            self.error = _scrub(f"{type(exc).__name__}: {exc}")
            # tag the exception with the INNERMOST span it crossed, so a
            # later catcher can link to the operation that actually failed
            if not hasattr(exc, "_psds_span"):
                try:
                    exc._psds_span = self.ids
                except Exception:  # lint: allow-broad-except(exceptions with __slots__ can't be tagged)
                    pass
        self.tracer._pop(self)
        return False


class Tracer:
    """Span factory + per-thread context stack + open-span registry.

    ``enabled=False`` (the default) makes :meth:`span` return the shared
    :data:`NULL_SPAN` after one attribute check and a check that no
    profiler records — the whole subsystem then costs nothing and emits
    nothing.  When enabled, finished spans are appended to ``recorder``
    (a :class:`~.recorder.FlightRecorder`) and open spans are tracked so
    a flight dump taken mid-request can include the request's
    in-progress timeline."""

    def __init__(self, *, enabled: bool = False, recorder=None,
                 clock=time.monotonic) -> None:
        self.enabled = bool(enabled)
        self.recorder = recorder
        self._clock = clock
        self._tls = threading.local()
        self._lock = new_lock("tracer")
        self._active: dict[str, Span] = {}

    # ------------------------------------------------------------- context
    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def current(self) -> Optional[Span]:
        """The innermost open span on this thread, or None (always None
        when disabled)."""
        if not self.enabled:
            return None
        st = getattr(self._tls, "stack", None)
        return st[-1] if st else None

    def _push(self, span: Span) -> None:
        self._stack().append(span)
        with self._lock:
            self._active[span.span_id] = span

    def _pop(self, span: Span) -> None:
        st = self._stack()
        if st and st[-1] is span:
            st.pop()
        elif span in st:  # mispaired exit: drop it wherever it sits
            st.remove(span)
        with self._lock:
            self._active.pop(span.span_id, None)
        rec = self.recorder
        if rec is not None:
            rec.record(span.entry())

    # --------------------------------------------------------------- spans
    def span(self, name: str, *, trace=None, parent: Optional[Span] = None,
             device_ms=None, **attrs):
        """Open a span.  Parent resolution: explicit ``parent`` >
        ``trace`` (a remote ``[trace_id, span_id]`` context from a frame
        header) > this thread's current span > new root.  ``device_ms``
        (the device the span's work runs on) records the span's device
        time when it is a CUDA device.  Returns :data:`NULL_SPAN` when
        disabled, or a bare profiler range while a profiler records."""
        if not self.enabled:
            return profiler_range(name)
        trace_id = parent_id = None
        if parent is not None and isinstance(parent, Span):
            trace_id, parent_id = parent.trace_id, parent.span_id
        elif (isinstance(trace, (list, tuple)) and len(trace) == 2
              and all(isinstance(x, str) for x in trace)):
            trace_id, parent_id = trace[0][:64], trace[1][:64]
        else:
            cur = self.current()
            if cur is not None:
                trace_id, parent_id = cur.trace_id, cur.span_id
        if trace_id is None:
            trace_id = f"{_rng.getrandbits(64):016x}"
        return Span(self, name, trace_id, f"{_rng.getrandbits(64):016x}",
                    parent_id, {k: _scrub(v) for k, v in attrs.items()},
                    device_ms if _cuda(device_ms) else None)

    def event(self, name: str, **attrs) -> None:
        """A standalone structured event: recorded to the flight ring,
        stamped with the current span's ids when one is open."""
        if not self.enabled or self.recorder is None:
            return
        cur = self.current()
        self.recorder.record({
            "kind": "event", "name": str(name),
            "trace": cur.trace_id if cur is not None else None,
            "span": cur.span_id if cur is not None else None,
            "thread": threading.current_thread().name,
            "attrs": {k: _scrub(v) for k, v in attrs.items()},
        })

    def annotate(self, **attrs) -> None:
        """Set attributes on the current span, if any (no-op when off)."""
        cur = self.current()
        if cur is not None:
            for k, v in attrs.items():
                cur.set(k, v)

    def active_entries(self) -> list[dict]:
        """Serialized snapshots of every OPEN span, across all threads —
        what makes a flight dump taken mid-request (a fault firing
        inside a dispatch) still show the request being served."""
        with self._lock:
            spans = list(self._active.values())
        out = []
        for s in spans:
            try:
                out.append(s.entry(open=True))
            except Exception:  # lint: allow-broad-except(racing mutation on another thread)
                continue
        return out
