"""Deterministic discrete-event loop: a priority queue over SimClock.

A copy of the JAX package's ``fleetsim/events.py``.

The loop is the only thing that moves simulated time.  Events are
``(fire_at, seq, label, fn)`` entries in a heap; ``seq`` is a global
admission counter so two events scheduled for the same instant dispatch
in scheduling order — heap ties never fall through to comparing
callables, and the timeline is reproducible without any randomness.

Chaos parity with the live plane: every dispatch passes through the
``sim.event`` fault site (faults/plan.py).  An injected error drops that
one event — counted in ``sim_event_faults`` on the loop's registry —
and the simulation continues, mirroring how a live controller survives
one bad tick (``autopilot.decide``).  ``InjectedThreadDeath`` is a
BaseException and still kills the loop, as everywhere else.
"""

from __future__ import annotations

import heapq
from typing import Callable, Optional

from .. import faults as F
from .clock import SimClock


class EventLoop:
    """Priority-queue event dispatcher over an injected :class:`SimClock`.

        loop = EventLoop(clock)
        loop.after(1.0, lambda: ...)       # relative schedule
        loop.at(5.0, lambda: ..., label="tick")
        loop.run_until(60.0)

    Callbacks may schedule further events (that is how periodic ticks
    are built).  ``run_until`` dispatches every event with
    ``fire_at <= horizon`` then advances the clock exactly to the
    horizon, so back-to-back runs compose: the clock never overshoots.
    """

    def __init__(self, clock: Optional[SimClock] = None, *,
                 registry=None) -> None:
        self.clock = clock if clock is not None else SimClock()
        self.registry = registry
        self._heap: list = []
        self._seq = 0          # admission order: the deterministic tie-break
        self.dispatched = 0    # events actually run (faulted ones excluded)

    # ---------------------------------------------------------- scheduling
    def at(self, t: float, fn: Callable[[], None], *,
           label: str = "") -> None:
        """Schedule ``fn`` at absolute simulated time ``t``."""
        t = float(t)
        if t < self.clock():
            raise ValueError(
                f"cannot schedule into the past: t={t} < now={self.clock()}")
        heapq.heappush(self._heap, (t, self._seq, str(label), fn))
        self._seq += 1

    def after(self, dt: float, fn: Callable[[], None], *,
              label: str = "") -> None:
        """Schedule ``fn`` ``dt`` seconds from now."""
        self.at(self.clock() + float(dt), fn, label=label)

    def __len__(self) -> int:
        return len(self._heap)

    # ----------------------------------------------------------- dispatch
    def step(self) -> bool:
        """Dispatch the single earliest event; False when idle."""
        if not self._heap:
            return False
        t, _, label, fn = heapq.heappop(self._heap)
        self.clock.advance_to(t)
        try:
            F.fire("sim.event")
        except F.InjectedThreadDeath:
            raise
        except Exception:  # lint: allow-broad-except(injected event fault drops one event, counted)
            if self.registry is not None:
                self.registry.inc("sim_event_faults")
            return True
        fn()
        self.dispatched += 1
        if self.registry is not None:
            self.registry.inc("sim_events")
        return True

    def run_until(self, horizon: float) -> int:
        """Dispatch every event due at or before ``horizon`` (inclusive),
        then land the clock exactly on the horizon.  Returns the number
        of dispatch attempts."""
        horizon = float(horizon)
        n = 0
        while self._heap and self._heap[0][0] <= horizon:
            self.step()
            n += 1
        if horizon > self.clock():
            self.clock.advance_to(horizon)
        return n

    def run(self) -> int:
        """Drain the queue completely (scenarios with a natural end)."""
        n = 0
        while self.step():
            n += 1
        return n
