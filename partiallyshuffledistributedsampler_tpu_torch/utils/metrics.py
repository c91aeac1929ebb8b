"""Regen-latency counters (the headline metric: per-epoch index-gen ms).

Lightweight and dependency-free; the sampler keeps one ``RegenTimer`` so a
training loop reads the per-epoch regen time the same way a benchmark does.
:class:`MetricsRegistry` is the shared named-metric surface subsystems
export through (counters, timers and :class:`Histogram` s under one
report, rendered for Prometheus by ``telemetry.render_prometheus``).  The
JAX package's ``utils/metrics.py``, line for line: the same observations
give the same percentiles, deltas and reports in both packages.
"""

from __future__ import annotations

import bisect
import math
import time
from collections import deque
from contextlib import contextmanager

from ..analysis.lockorder import new_lock


class _SampleRing:
    """Fixed-size tail of samples with exact running totals.

    Keeps the list surface existing consumers rely on (``len``, ``bool``,
    iteration, negative indexing, ``clear()``) while bounding memory: the
    deque holds only the most recent ``cap`` samples, and ``total`` /
    ``count`` accumulate across everything ever appended so means stay
    exact after old samples fall off.  ``clear()`` resets the totals too
    (benchmark warmup resets depend on that)."""

    __slots__ = ("_d", "total", "count")

    def __init__(self, cap: int) -> None:
        self._d: deque = deque(maxlen=max(1, int(cap)))
        self.total = 0.0
        self.count = 0

    def append(self, v: float) -> None:
        v = float(v)
        self._d.append(v)
        self.total += v
        self.count += 1

    def clear(self) -> None:
        self._d.clear()
        self.total = 0.0
        self.count = 0

    def __len__(self) -> int:
        return len(self._d)

    def __bool__(self) -> bool:
        return bool(self._d)

    def __getitem__(self, i):
        return self._d[i]

    def __iter__(self):
        return iter(self._d)

    def __repr__(self) -> str:
        return (f"_SampleRing(cap={self._d.maxlen}, kept={len(self._d)}, "
                f"count={self.count})")


class RegenTimer:
    """Accumulates per-epoch regen latencies.

        timer = RegenTimer()
        with timer.measure():
            idx = epoch_indices_jax(...); idx.block_until_ready()
        timer.last_ms, timer.mean_ms, timer.count

    ``samples_ms`` is a bounded ring (default 1024 entries): a
    long-running daemon timing one regen per epoch×rank keeps only the
    recent tail, while ``count``/``mean_ms`` stay exact via running
    totals maintained by the ring itself."""

    def __init__(self, max_samples: int = 1024) -> None:
        self.samples_ms = _SampleRing(max_samples)

    @contextmanager
    def measure(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples_ms.append((time.perf_counter() - t0) * 1e3)

    @property
    def count(self) -> int:
        return self.samples_ms.count

    @property
    def last_ms(self) -> float:
        return self.samples_ms[-1] if self.samples_ms else 0.0

    @property
    def mean_ms(self) -> float:
        ring = self.samples_ms
        return ring.total / ring.count if ring.count else 0.0

    def report(self) -> dict:
        return {
            "epochs_timed": self.count,
            "last_ms": round(self.last_ms, 3),
            "mean_ms": round(self.mean_ms, 3),
        }


#: default histogram bounds: log-spaced ×2 from 1 µs up to ~35 minutes
#: (in ms) — covers a fast loopback RPC through a pathological barrier
_DEFAULT_BOUNDS = tuple(0.001 * 2 ** k for k in range(32))


def _percentile_from(bounds, counts, count, vmin, vmax, q: float) -> float:
    """Interpolated q-quantile over raw bucket ``counts`` (overflow bucket
    last).  Pure — :class:`Histogram` delegates here for its lifetime
    percentiles and :func:`histogram_delta` reuses it on interval-delta
    counts, so windowed and cumulative views cannot drift apart."""
    if count <= 0:
        return 0.0
    target = q * count
    cum = 0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        if cum + c >= target:
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i] if i < len(bounds) else vmax
            frac = (target - cum) / c
            est = lo + (hi - lo) * max(0.0, min(1.0, frac))
            return max(vmin, min(vmax, est))
        cum += c
    return vmax


def histogram_delta(cur: dict, prev=None) -> dict:
    """Windowed report between two :meth:`Histogram.snapshot` values.

    ``prev=None`` means "since the start" (an all-zero baseline), so the
    delta of a first interval equals the lifetime report.  Interval
    percentiles interpolate the *differenced* bucket counts; min/max are
    not tracked per interval, so the estimate clamps to the lifetime
    envelope — good enough for a controller comparing against
    thresholds, and exact whenever an interval spans the whole life."""
    bounds = cur["bounds"]
    if prev is None:
        dcounts = list(cur["counts"])
        dsum = float(cur["sum"])
        dcount = int(cur["count"])
    else:
        dcounts = [int(c) - int(p)
                   for c, p in zip(cur["counts"], prev["counts"])]
        dsum = float(cur["sum"]) - float(prev["sum"])
        dcount = int(cur["count"]) - int(prev["count"])
    if dcount <= 0:
        return {"count": 0, "mean_ms": 0.0, "p50_ms": 0.0,
                "p95_ms": 0.0, "p99_ms": 0.0, "max_ms": 0.0}
    vmin, vmax = float(cur["min"]), float(cur["max"])
    return {
        "count": dcount,
        "mean_ms": round(dsum / dcount, 3),
        "p50_ms": round(_percentile_from(bounds, dcounts, dcount,
                                         vmin, vmax, 0.50), 3),
        "p95_ms": round(_percentile_from(bounds, dcounts, dcount,
                                         vmin, vmax, 0.95), 3),
        "p99_ms": round(_percentile_from(bounds, dcounts, dcount,
                                         vmin, vmax, 0.99), 3),
        "max_ms": round(vmax, 3),
    }


def registry_delta(cur: dict, prev=None) -> dict:
    """Windowed view between two :meth:`MetricsRegistry.snapshot` values:
    counter differences plus :func:`histogram_delta` per histogram.
    Counters absent from ``prev`` delta from zero (created mid-window)."""
    pc = (prev or {}).get("counters") or {}
    ph = (prev or {}).get("histograms") or {}
    return {
        "counters": {k: int(v) - int(pc.get(k, 0))
                     for k, v in cur.get("counters", {}).items()},
        "histograms": {k: histogram_delta(s, ph.get(k))
                       for k, s in cur.get("histograms", {}).items()},
    }


class Histogram:
    """Fixed log-spaced latency buckets with exact count/sum.

        h = Histogram()
        h.observe(rpc_ms)
        h.report()  # {"count", "mean_ms", "p50_ms", "p95_ms", "p99_ms", ...}

    Buckets are upper bounds in milliseconds (default ×2 log-spaced from
    1 µs to ~35 min); one overflow bucket catches the rest.  Percentiles
    are linearly interpolated inside the winning bucket, clamped to the
    observed min/max, so a handful of samples still report sane numbers.
    Thread-safe; ``observe`` is a bisect + two adds under a lock."""

    __slots__ = ("_lock", "bounds", "_counts", "_sum", "_count",
                 "_min", "_max")

    def __init__(self, bounds=None) -> None:
        self._lock = new_lock("metrics.histogram")
        self.bounds = tuple(float(b) for b in (bounds or _DEFAULT_BOUNDS))
        if list(self.bounds) != sorted(self.bounds):
            raise ValueError("histogram bounds must be sorted ascending")
        self._counts = [0] * (len(self.bounds) + 1)  # guarded by: self._lock
        self._sum = 0.0  # guarded by: self._lock
        self._count = 0  # guarded by: self._lock
        self._min = math.inf  # guarded by: self._lock
        self._max = -math.inf  # guarded by: self._lock

    def observe(self, value_ms: float) -> None:
        v = float(value_ms)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def percentile(self, q: float) -> float:
        """Interpolated q-quantile (q in [0, 1]) from the bucket counts."""
        with self._lock:
            return self._percentile_locked(q)

    def _percentile_locked(self, q: float) -> float:
        return _percentile_from(self.bounds, self._counts, self._count,
                                self._min, self._max, q)

    def snapshot(self) -> dict:
        """Immutable point-in-time capture: every bucket count (overflow
        last), sum/count, and the observed min/max envelope.  The shared
        interval primitive — feed two of these to :func:`histogram_delta`
        (or ``delta(prev)``) for a windowed report; ``state()`` and the
        Prometheus exporter derive from the same capture."""
        with self._lock:
            return {
                "bounds": self.bounds,
                "counts": tuple(self._counts),
                "sum": self._sum,
                "count": self._count,
                "min": self._min,
                "max": self._max,
            }

    def delta(self, prev=None) -> dict:
        """Report over the interval since ``prev`` (an earlier
        ``snapshot()``; ``None`` = since start).  See
        :func:`histogram_delta`."""
        return histogram_delta(self.snapshot(), prev)

    def state(self) -> dict:
        """Raw bucket state for exporters (per-bucket, not cumulative)."""
        s = self.snapshot()
        return {
            "bounds": list(s["bounds"]),
            "counts": list(s["counts"][:-1]),
            "overflow": s["counts"][-1],
            "sum": s["sum"],
            "count": s["count"],
        }

    def report(self) -> dict:
        with self._lock:
            if self._count == 0:
                return {"count": 0, "mean_ms": 0.0, "p50_ms": 0.0,
                        "p95_ms": 0.0, "p99_ms": 0.0, "max_ms": 0.0}
            return {
                "count": self._count,
                "mean_ms": round(self._sum / self._count, 3),
                "p50_ms": round(self._percentile_locked(0.50), 3),
                "p95_ms": round(self._percentile_locked(0.95), 3),
                "p99_ms": round(self._percentile_locked(0.99), 3),
                "max_ms": round(self._max, 3),
            }


class MetricsRegistry:
    """Thread-safe named counters + latency timers + histograms under one
    report.

        reg = MetricsRegistry()
        reg.inc("batches_served")
        with reg.timer("epoch_regen_ms").measure():
            regenerate()
        reg.histogram("rpc_ms").observe(1.25)
        reg.report()  # {"counters": {...}, "timers": {...}, "histograms": {...}}

    Counters are plain monotonically-increasing ints; timers are
    :class:`RegenTimer` instances created on first use; histograms are
    :class:`Histogram` instances created on first use (``rpc_ms``,
    ``batch_service_ms``, ``barrier_freeze_ms``, ``barrier_drain_ms``,
    ``epoch_regen_ms`` in the served-index stack).  Every method is
    safe from concurrent threads (the service daemon increments from one
    thread per connection)."""

    def __init__(self) -> None:
        self._lock = new_lock("metrics.registry")
        self._counters: dict[str, int] = {}  # guarded by: self._lock
        self._timers: dict[str, RegenTimer] = {}  # guarded by: self._lock
        self._histograms: dict[str, Histogram] = {}  # guarded by: self._lock

    def inc(self, name: str, value: int = 1) -> int:
        with self._lock:
            new = self._counters.get(name, 0) + int(value)
            self._counters[name] = new
            return new

    def get(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def timer(self, name: str) -> RegenTimer:
        with self._lock:
            t = self._timers.get(name)
            if t is None:
                t = self._timers[name] = RegenTimer()
            return t

    def histogram(self, name: str, bounds=None) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(bounds)
            return h

    def histogram_states(self) -> dict:
        """Raw bucket states keyed by name (exporter surface — see
        ``telemetry.render_prometheus``)."""
        with self._lock:
            hs = dict(self._histograms)
        return {k: h.state() for k, h in hs.items()}

    def snapshot(self) -> dict:
        """Point-in-time capture of counters + histogram snapshots —
        the interval baseline the autopilot controller (and anything
        else computing windowed load) holds between samples.  Timers are
        excluded: their rings are already windowed by construction."""
        with self._lock:
            counters = dict(self._counters)
            hs = dict(self._histograms)
        return {"counters": counters,
                "histograms": {k: h.snapshot() for k, h in hs.items()}}

    def delta(self, prev=None) -> dict:
        """Windowed view since ``prev`` (an earlier ``snapshot()``;
        ``None`` = since start).  See :func:`registry_delta`."""
        return registry_delta(self.snapshot(), prev)

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._timers.clear()
            self._histograms.clear()

    def report(self) -> dict:
        with self._lock:
            return {
                "counters": dict(self._counters),
                "timers": {k: t.report() for k, t in self._timers.items()},
                "histograms": {k: h.report()
                               for k, h in self._histograms.items()},
            }
