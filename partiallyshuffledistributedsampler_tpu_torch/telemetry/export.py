"""Exporters: Prometheus-style text rendering + a buffered JSONL sink.

Two ways out of the process:

* :func:`render_prometheus` turns a ``MetricsRegistry`` (or a
  ``ServiceMetrics`` wrapper) into the Prometheus text exposition
  format — counters as plain gauges, timers as ``_count``/``_sum``
  pairs, histograms as cumulative ``_bucket{le=...}`` series.  It is a
  pure function over a point-in-time snapshot; serve it from any HTTP
  handler or write it to a textfile-collector path.

* :class:`JsonlSink` is a live entry exporter for the flight recorder:
  buffered appends with periodic flush, so tracing a long run streams
  to disk without an fsync per span.  An entry whose device interval the
  card has not reached yet waits in the buffer for a later flush (an
  explicit ``flush()`` or ``close()`` waits for it), so the sink never
  makes the span that wrote it wait for the card.
"""

from __future__ import annotations

import json
import math
import time
from typing import Optional

from ..analysis.lockorder import new_lock
from .trace import pending, resolve


def _fsync_fileobj(f) -> None:
    # deferred: utils.retry imports telemetry, so a module-level import
    # of utils.checkpoint here would be circular
    from ..utils.checkpoint import fsync_fileobj
    fsync_fileobj(f)


def _prom_name(prefix: str, name: str) -> str:
    out = []
    for ch in f"{prefix}_{name}" if prefix else name:
        out.append(ch if (ch.isalnum() or ch == "_") else "_")
    s = "".join(out)
    return s if not s[:1].isdigit() else "_" + s


def _fmt(v: float) -> str:
    if v != v:  # NaN
        return "NaN"
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def render_prometheus(registry, prefix: str = "psds") -> str:
    """Render a registry snapshot in Prometheus text format.

    Accepts a ``MetricsRegistry`` or anything with a ``.registry``
    attribute pointing at one (``ServiceMetrics``,
    ``HostDataLoader.metrics`` both qualify)."""
    reg = getattr(registry, "registry", registry)
    report = reg.report()
    # counters + histogram buckets come from the same interval-snapshot
    # primitive the autopilot controller samples (MetricsRegistry
    # .snapshot(), utils/metrics.py): one capture path, two consumers
    take = getattr(reg, "snapshot", None)
    snap = take() if take is not None else {
        "counters": report.get("counters", {}), "histograms": {}}
    lines: list[str] = []

    for name, value in sorted(snap.get("counters", {}).items()):
        n = _prom_name(prefix, name)
        lines.append(f"# TYPE {n} counter")
        lines.append(f"{n} {_fmt(value)}")

    for name, t in sorted(report.get("timers", {}).items()):
        n = _prom_name(prefix, name + "_ms")
        lines.append(f"# TYPE {n} summary")
        count = t.get("epochs_timed", t.get("count", 0))
        lines.append(f"{n}_count {_fmt(count)}")
        lines.append(f"{n}_sum {_fmt(t.get('mean_ms', 0.0) * count)}")

    for name, st in sorted(snap.get("histograms", {}).items()):
        n = _prom_name(prefix, name)
        lines.append(f"# TYPE {n} histogram")
        cum = 0
        for le, c in zip(st["bounds"], st["counts"][:-1]):
            cum += c
            lines.append(f'{n}_bucket{{le="{_fmt(le)}"}} {cum}')
        lines.append(f'{n}_bucket{{le="+Inf"}} {st["count"]}')
        lines.append(f"{n}_sum {_fmt(st['sum'])}")
        lines.append(f"{n}_count {st['count']}")

    return "\n".join(lines) + ("\n" if lines else "")


class JsonlSink:
    """Buffered JSONL writer for telemetry entries.

    Entries accumulate in memory and are flushed when ``batch`` entries
    are pending or ``interval_s`` has elapsed since the last flush,
    whichever comes first.  ``close()`` flushes the tail; the sink is
    also a context manager.  ``durable=True`` fsyncs on every explicit
    ``flush()``/``close()`` (through the same
    :func:`~..utils.checkpoint.fsync_fileobj` primitive the snapshots
    use), so the telemetry written just before a host dies survives it
    — the interval/batch flushes stay cheap page-cache writes."""

    def __init__(self, path: str, interval_s: float = 2.0,
                 batch: int = 64, durable: bool = False) -> None:
        self.path = str(path)
        self.interval_s = float(interval_s)
        self.batch = max(1, int(batch))
        self.durable = bool(durable)
        self._lock = new_lock("telemetry.sink")
        self._buf: list[dict] = []
        self._last_flush = time.monotonic()
        self._f = open(self.path, "a", encoding="utf-8")
        self.written = 0

    def write(self, entry: dict) -> None:
        with self._lock:
            self._buf.append(entry)
            due = (len(self._buf) >= self.batch
                   or time.monotonic() - self._last_flush >= self.interval_s)
            if due:
                self._flush_locked(wait=False)

    def flush(self) -> None:
        with self._lock:
            self._flush_locked(wait=True)
            if self.durable and not self._f.closed:
                _fsync_fileobj(self._f)

    def _flush_locked(self, wait: bool) -> None:
        """Write the buffered entries in order, up to the first whose
        device interval is still pending (``wait``: all of them)."""
        n = len(self._buf) if wait else next(
            (i for i, e in enumerate(self._buf) if pending(e)),
            len(self._buf))
        if n:
            self._f.write("\n".join(
                json.dumps(resolve(e), separators=(",", ":"), default=repr)
                for e in self._buf[:n]) + "\n")
            self._f.flush()
            self.written += n
            del self._buf[:n]
        self._last_flush = time.monotonic()

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._flush_locked(wait=True)
                if self.durable:
                    _fsync_fileobj(self._f)
                self._f.close()

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc) -> Optional[bool]:
        self.close()
        return None
