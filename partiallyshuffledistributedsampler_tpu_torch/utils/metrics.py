"""Regen-latency counters (the headline metric: per-epoch index-gen ms).

Lightweight and dependency-free; the sampler keeps one ``RegenTimer`` so a
training loop reads the per-epoch regen time the same way a benchmark does.
"""

from __future__ import annotations

import time
from collections import deque
from contextlib import contextmanager


class _SampleRing:
    """Fixed-size tail of samples with exact running totals.

    Keeps the list surface consumers rely on (``len``, ``bool``, iteration,
    negative indexing, ``clear()``) while bounding memory: the deque holds
    only the most recent ``cap`` samples, and ``total`` / ``count``
    accumulate across everything ever appended so means stay exact after
    old samples fall off.  ``clear()`` resets the totals too."""

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
            idx = sampler.epoch_indices()
        timer.last_ms, timer.mean_ms, timer.count

    ``samples_ms`` is a bounded ring (default 1024 entries); ``count`` and
    ``mean_ms`` stay exact via the ring's running totals."""

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
