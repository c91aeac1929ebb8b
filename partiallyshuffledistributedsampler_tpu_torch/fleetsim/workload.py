"""Deterministic per-rank demand profiles for the fleet simulator.

A copy of the JAX package's ``fleetsim/workload.py``.

A :class:`Workload` is a pure function ``rate(rank, t) -> samples/s``
plus a stable ``key`` naming the workload shape (the same key the
autopilot's prior store indexes on, so a simulated convergence warms a
simulated restart).  Profiles are closed-form — no randomness at
evaluation time — which keeps a 5 000-rank × hundreds-of-ticks scenario
cheap and exactly replayable.

Built-in shapes:

* :func:`uniform` — every rank demands the same steady rate.
* :func:`hotspot` — a contiguous band of ranks ramps linearly from the
  base rate to ``factor``× over ``ramp_s`` seconds starting at
  ``at_s``: the canonical "one shard goes hot" scenario the split /
  migrate arms must resolve unattended (docs/SIMULATOR.md).
* :func:`surge` — the whole fleet steps to ``factor``× at ``at_s``
  (capacity exhaustion: the shed arm's scenario).
"""

from __future__ import annotations

from typing import Callable


class Workload:
    """A named, pure per-rank demand profile."""

    def __init__(self, key: str,
                 rate: Callable[[int, float], float]) -> None:
        self.key = str(key)
        self._rate = rate

    def rate(self, rank: int, t: float) -> float:
        """Demand in samples/s for ``rank`` at simulated time ``t``."""
        return float(self._rate(int(rank), float(t)))

    def total(self, world: int, t: float) -> float:
        return sum(self.rate(r, t) for r in range(int(world)))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Workload({self.key!r})"


def uniform(rate_per_rank: float, *, key: str = "") -> Workload:
    """Every rank demands ``rate_per_rank`` samples/s, forever."""
    r = float(rate_per_rank)
    return Workload(key or f"uniform_{r:g}", lambda rank, t: r)


def hotspot(base_rate: float, *, hot_lo: int, hot_hi: int,
            factor: float, at_s: float, ramp_s: float,
            key: str = "") -> Workload:
    """Ranks in ``[hot_lo, hot_hi)`` ramp linearly from ``base_rate``
    to ``factor * base_rate`` over ``ramp_s`` seconds starting at
    ``at_s``; everyone else stays at the base rate."""
    base, f = float(base_rate), float(factor)
    lo, hi = int(hot_lo), int(hot_hi)
    t0, ramp = float(at_s), max(1e-9, float(ramp_s))

    def rate(rank: int, t: float) -> float:
        if not lo <= rank < hi or t < t0:
            return base
        frac = min(1.0, (t - t0) / ramp)
        return base * (1.0 + (f - 1.0) * frac)

    return Workload(
        key or f"hotspot_{base:g}x{f:g}_r{lo}-{hi}", rate)


def surge(base_rate: float, *, factor: float, at_s: float,
          key: str = "") -> Workload:
    """The whole fleet steps to ``factor * base_rate`` at ``at_s``."""
    base, f, t0 = float(base_rate), float(factor), float(at_s)
    return Workload(
        key or f"surge_{base:g}x{f:g}",
        lambda rank, t: base * f if t >= t0 else base)
