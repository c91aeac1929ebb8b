"""`RetryPolicy`: one value object for every retry loop in the stack.

Before this module the service client carried three hand-rolled
``time.sleep(self.backoff_base)`` variants (reconnect, lease race,
lease-race-at-connect), each with its own idea of backoff and none with
jitter on the lease paths — so N ranks dropped by one server restart
retried in lockstep.  The policy centralizes the four knobs that matter:

* **exponential backoff + full jitter** — attempt ``k`` sleeps
  ``uniform(0, min(max_delay, base * 2**k))`` (the AWS "full jitter"
  scheme: the strongest decorrelation for a retrying herd);
* **deadline** — a per-operation wall-clock budget; an operation begun
  with :meth:`begin` refuses to sleep past it;
* **retry budget** — an optional hard cap on attempts per operation;
* **circuit breaker** — after ``breaker_threshold`` *consecutive*
  failures the policy reports ``allow() == False`` for
  ``breaker_reset`` seconds, then admits half-open probes (a success
  closes the circuit, a failure re-opens it) — so a caller facing a dead
  dependency fails fast instead of paying the full deadline on every
  call.

``clock``/``sleep``/``rng`` are injectable for deterministic tests.
"""

from __future__ import annotations

import random
import time
from typing import Optional

from ..telemetry import current as _current_span
from ..analysis.lockorder import new_lock


class RetryPolicy:
    """Shared retry semantics + breaker state; one instance per dependency.

        policy = RetryPolicy(base=0.05, max_delay=2.0, deadline=30.0)
        op = policy.begin()
        while True:
            if not policy.allow():
                raise Unavailable("circuit open")
            try:
                result = attempt()
                policy.record_success()
                break
            except TransientError:
                policy.record_failure()
                if not op.pause():       # jittered sleep, deadline-aware
                    raise                # budget/deadline exhausted

    The policy object holds only cross-operation state (the breaker);
    per-operation attempt counts and deadlines live in the
    :class:`RetryState` returned by :meth:`begin`, so one policy is safe
    to share across threads.
    """

    def __init__(
        self,
        *,
        base: float = 0.05,
        max_delay: float = 2.0,
        deadline: Optional[float] = 30.0,
        budget: Optional[int] = None,
        breaker_threshold: Optional[int] = None,
        breaker_reset: float = 1.0,
        clock=time.monotonic,
        sleep=time.sleep,
        rng: Optional[random.Random] = None,
    ) -> None:
        if base < 0 or max_delay < 0:
            raise ValueError("base and max_delay must be >= 0")
        if deadline is not None and deadline < 0:
            raise ValueError(f"deadline must be >= 0, got {deadline}")
        if budget is not None and budget < 1:
            raise ValueError(f"budget must be >= 1, got {budget}")
        if breaker_threshold is not None and breaker_threshold < 1:
            raise ValueError(
                f"breaker_threshold must be >= 1, got {breaker_threshold}"
            )
        self.base = float(base)
        self.max_delay = float(max_delay)
        self.deadline = None if deadline is None else float(deadline)
        self.budget = budget
        self.breaker_threshold = breaker_threshold
        self.breaker_reset = float(breaker_reset)
        self._clock = clock
        self._sleep = sleep
        self._rng = rng if rng is not None else random.Random()
        self._lock = new_lock("utils.retry")
        self._consecutive_failures = 0
        self._opened_at: Optional[float] = None

    # ------------------------------------------------------------- breaker
    def allow(self) -> bool:
        """False only while the circuit is open and the reset interval has
        not yet elapsed; past it, callers are admitted as half-open
        probes."""
        if self.breaker_threshold is None:
            return True
        with self._lock:
            if self._opened_at is None:
                return True
            return self._clock() - self._opened_at >= self.breaker_reset

    @property
    def circuit_open(self) -> bool:
        return not self.allow()

    def record_failure(self) -> None:
        with self._lock:
            self._consecutive_failures += 1
            if self.breaker_threshold is None:
                return
            now = self._clock()
            if self._opened_at is None:
                if self._consecutive_failures >= self.breaker_threshold:
                    self._opened_at = now
            elif now - self._opened_at >= self.breaker_reset:
                # a failed half-open probe re-opens for a fresh interval
                self._opened_at = now

    def record_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            self._opened_at = None

    # ----------------------------------------------------------- operations
    def begin(self) -> "RetryState":
        """Start one operation's retry clock (deadline measured from now)."""
        return RetryState(self)

    def backoff(self, attempt: int) -> float:
        """The full-jittered delay for 0-based ``attempt``."""
        envelope = min(self.max_delay, self.base * (2.0 ** attempt))
        return self._rng.uniform(0.0, envelope)


class RetryState:
    """One operation's attempts against a :class:`RetryPolicy`."""

    def __init__(self, policy: RetryPolicy) -> None:
        self.policy = policy
        self.attempts = 0
        self.started = policy._clock()
        self.deadline = (
            None if policy.deadline is None
            else self.started + policy.deadline
        )

    def remaining(self) -> float:
        """Seconds left before the operation's deadline (inf if none)."""
        if self.deadline is None:
            return float("inf")
        return self.deadline - self.policy._clock()

    def pause(self, min_delay: float = 0.0) -> bool:
        """Sleep the next backoff (at least ``min_delay``); False — without
        sleeping — when the attempt budget or the deadline would be
        exceeded, i.e. the caller must stop retrying."""
        pol = self.policy
        delay = max(float(min_delay), pol.backoff(self.attempts))
        self.attempts += 1
        if pol.budget is not None and self.attempts > pol.budget:
            return False
        if self.deadline is not None \
                and pol._clock() + delay > self.deadline:
            return False
        sp = _current_span()
        if sp is not None:
            # the retry timeline rides the operation's span (no-op when
            # tracing is off: current() is then always None)
            sp.event("retry_pause", attempt=self.attempts,
                     delay_ms=round(delay * 1e3, 3))
        pol._sleep(delay)
        return True
