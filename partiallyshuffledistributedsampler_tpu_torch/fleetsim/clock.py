"""The simulator's injected clock: virtual monotonic seconds.

A copy of the JAX package's ``fleetsim/clock.py``.

Every component under simulation — the event loop, the latency models,
and most importantly the *real* :class:`~..autopilot.AutopilotPolicy` —
reads time by calling this object.  Nothing in ``fleetsim`` ever reads a
wall clock: the same seed and scenario therefore produce the same
timeline on a laptop and on CI, byte for byte (docs/SIMULATOR.md).
"""

from __future__ import annotations


class SimClock:
    """Callable virtual clock; only :class:`~.events.EventLoop` advances it.

        clock = SimClock()
        clock()            # 0.0
        clock.advance(1.5)
        clock()            # 1.5

    Passing the instance as ``clock=`` anywhere a component accepts an
    injected monotonic-seconds callable (``AutopilotPolicy``,
    ``Autopilot``) makes that component live on simulated time.
    """

    __slots__ = ("_now",)

    def __init__(self, start: float = 0.0) -> None:
        self._now = float(start)

    def __call__(self) -> float:
        return self._now

    def advance(self, dt: float) -> float:
        """Move time forward by ``dt`` seconds (never backward)."""
        dt = float(dt)
        if dt < 0.0:
            raise ValueError(f"simulated time cannot run backward: {dt}")
        self._now += dt
        return self._now

    def advance_to(self, t: float) -> float:
        """Jump to absolute time ``t`` (the event loop's dispatch step)."""
        t = float(t)
        if t < self._now:
            raise ValueError(
                f"cannot rewind simulated clock from {self._now} to {t}")
        self._now = t
        return self._now

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"SimClock(t={self._now:.6f})"
