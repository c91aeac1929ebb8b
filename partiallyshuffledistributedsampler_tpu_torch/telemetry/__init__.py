"""End-to-end host tracing, flight recorder, and metrics export.

Process-global facade over :mod:`.trace`, :mod:`.recorder`, and
:mod:`.export` — one tracer + one flight recorder per process, **off by
default** and zero-cost while off (``span()`` returns a shared no-op
span; no ``trace`` field is added to protocol frames; ``auto_dump()``
does nothing).  See docs/OBSERVABILITY.md for the full tour; this is
a copy of the JAX package's ``telemetry/`` with its own process-global
state (the two packages' tracers are configured apart).

Enable programmatically::

    from partiallyshuffledistributedsampler_tpu_torch import telemetry
    telemetry.configure(enabled=True, dump_dir="/tmp/psds-flight")

or with ``PSDS_TELEMETRY=1`` (and optionally ``PSDS_FLIGHT_DIR=...``)
in the environment before import.  This module imports torch and
nothing from the rest of the package but the lock factory, so
every layer — the fault runtime, the regen entry points of ``ops/cuda.py``,
the loader — can hook into it without cycles.  A span times host calls:
it never synchronizes a CUDA stream.  Its entry's ``start_ns`` places it
on ``torch.profiler``'s clock, and a span opened with ``device_ms=`` a
CUDA device carries the device time between two events it recorded,
read when the ring is read.  While a profiler records, each span (traced
or not) and each :func:`profiler_range` enters a ``record_function``
range of its name; while none records, none is entered.
"""

from __future__ import annotations

import os
from typing import Optional

from .export import JsonlSink, render_prometheus
from .recorder import FlightRecorder
from .trace import NULL_SPAN, Span, Tracer, profiler_range

__all__ = [
    "Span", "Tracer", "FlightRecorder", "JsonlSink", "render_prometheus",
    "NULL_SPAN", "configure", "reset", "enabled", "tracer", "recorder",
    "span", "current", "annotate", "event", "snapshot", "dump",
    "auto_dump", "profiler_range",
]

_RECORDER = FlightRecorder(dump_dir=os.environ.get("PSDS_FLIGHT_DIR"))
_TRACER = Tracer(enabled=os.environ.get("PSDS_TELEMETRY", "") not in
                 ("", "0", "false", "off"), recorder=_RECORDER)


def configure(*, enabled: Optional[bool] = None,
              dump_dir: Optional[str] = None,
              capacity: Optional[int] = None,
              max_dumps: Optional[int] = None,
              sink=None) -> Tracer:
    """Reconfigure the process-global tracer/recorder in place.

    Only the arguments you pass change; passing ``capacity`` rebuilds
    the ring (existing entries are kept up to the new bound).  Returns
    the tracer for convenience."""
    global _RECORDER
    if capacity is not None:
        fresh = FlightRecorder(capacity=capacity,
                               dump_dir=_RECORDER.dump_dir,
                               max_dumps=_RECORDER.max_dumps,
                               sink=_RECORDER.sink)
        for e in _RECORDER.snapshot(limit=capacity):
            fresh.record(e)
        _RECORDER = fresh
        _TRACER.recorder = _RECORDER
    if dump_dir is not None:
        _RECORDER.dump_dir = dump_dir
    if max_dumps is not None:
        _RECORDER.max_dumps = int(max_dumps)
    if sink is not None:
        _RECORDER.sink = sink
    if enabled is not None:
        _TRACER.enabled = bool(enabled)
    return _TRACER


def reset() -> None:
    """Back to the off-by-default state with an empty ring (tests)."""
    sink = _RECORDER.sink
    if sink is not None:
        try:
            sink.close()
        except Exception:  # lint: allow-broad-except(best-effort sink close in reset)
            pass
    _RECORDER.sink = None
    _RECORDER.dump_dir = None
    _RECORDER.max_dumps = 16
    _RECORDER.clear()
    _RECORDER._dump_seq = 0
    _TRACER.enabled = False
    with _TRACER._lock:
        _TRACER._active.clear()


def enabled() -> bool:
    return _TRACER.enabled


def tracer() -> Tracer:
    return _TRACER


def recorder() -> FlightRecorder:
    return _RECORDER


def span(name: str, **kwargs):
    """Open a span on the global tracer (``trace=``/``parent=``/
    ``device_ms=`` pass through; everything else becomes span
    attributes).  Returns the shared no-op span when tracing is off (a
    bare profiler range while a profiler records)."""
    return _TRACER.span(name, **kwargs)


def current() -> Optional[Span]:
    return _TRACER.current()


def annotate(**attrs) -> None:
    _TRACER.annotate(**attrs)


def event(name: str, **attrs) -> None:
    _TRACER.event(name, **attrs)


def snapshot(limit: Optional[int] = None) -> list[dict]:
    """Recent entries from the flight ring (what TRACE_DUMP serves)."""
    return _RECORDER.snapshot(limit)


def dump(path: Optional[str] = None, reason: str = "manual") -> Optional[str]:
    """Write ring + open spans to ``path`` (or an auto-named file in the
    configured ``dump_dir``).  Returns the path written, or ``None`` if
    no destination is available."""
    extra = _TRACER.active_entries()
    if path is not None:
        return _RECORDER.dump(str(path), reason=reason, extra_entries=extra)
    return _RECORDER.auto_dump(reason, extra_entries=extra)


def auto_dump(reason: str, **attrs) -> Optional[str]:
    """Failure-triggered dump: record a marker event, then dump to the
    configured ``dump_dir``.  No-op (returns ``None``) when tracing is
    off or no ``dump_dir`` is set — the chaos matrices run with zero
    dump overhead unless a run opts in."""
    if not _TRACER.enabled or _RECORDER.dump_dir is None:
        return None
    _TRACER.event(f"flight_dump:{reason}", **attrs)
    return _RECORDER.auto_dump(reason, extra_entries=_TRACER.active_entries())
