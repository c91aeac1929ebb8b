"""Fault rules and plans: *when* a named site misbehaves, deterministically.

A rule's trigger is pure bookkeeping — per-site hit counters plus an
optional plan-seeded RNG — so the same plan against the same code path
fires at exactly the same points on every run.  What firing *does* is
the runtime module's job (:mod:`.runtime`).
"""

from __future__ import annotations

import json
import os
import random
from dataclasses import dataclass
from typing import Iterable, Optional

from ..analysis.lockorder import new_lock

#: the named points in the stack that consult the framework
SITES = frozenset({
    "service.send",          # client → server wire op (framed bytes)
    "service.recv",          # server → client wire op (reply frames)
    "server.dispatch",       # one request on a daemon serve thread
    "server.snapshot_write", # the daemon persisting its snapshot
    "server.reshard",        # a reshard barrier freezing / committing
    "server.zombie_write",   # a fenced ex-primary refusing a client write
    "repl.append",           # the primary appending a WAL record
    "repl.promote",          # a standby promoting itself to primary
    "wal.append",            # the durability WAL framing one record
    "wal.fsync",             # the durability WAL syncing its segment
    "wal.rotate",            # segment rollover / checkpoint GC truncation
    "client.leave",          # a client announcing its preemption drain
    "client.pipeline",       # the pipelined client topping up its window
    "tenant.admission",      # a HELLO admitting / creating a tenant
    "router.route",          # the shard router resolving a HELLO's shard
    "shard.barrier",         # a cross-shard set_epoch / reshard fan-out
    "loader.prefetch",       # one step of HostDataLoader's gather thread
    "loader.regen",          # local epoch index generation
    "loader.boundary",       # the epoch-boundary prefetch worker fetching
    "capability.issue",      # the daemon signing an epoch capability grant
    "capability.verify",     # a client verifying a received capability
    "stream.append",         # a feeder APPEND extending the index space
    "stream.advance",        # the ack-gated horizon-advance barrier
    "sampling.alias_build",  # building an epoch's weighted alias table
    "sampling.dedup_check",  # one seen-set membership test of a draw
    "autopilot.decide",      # the controller evaluating one policy tick
    "shard.split",           # the plane starting a split-off shard
    "shard.migrate",         # the two-phase cross-shard rank handoff
    "sim.event",             # fleetsim dispatching one queued event
    "sim.inject",            # fleetsim applying a scenario injection
    "cell.ship",             # the cross-cell WalShipper framing one batch
    "cell.fence",            # fencing one server of a superseded cell
    "cell.migrate",          # the two-phase cross-cell tenant cutover
})

#: what a firing rule does (interpreted by runtime.perform / the sites)
KINDS = frozenset({
    "reset",         # ConnectionResetError
    "delay",         # sleep delay_s
    "torn_frame",    # send a frame prefix, then reset (send sites)
    "corrupt",       # flip one payload byte (wire sites)
    "thread_death",  # InjectedThreadDeath (BaseException: thread dies quietly)
    "disk_full",     # OSError(ENOSPC)
    "error",         # generic typed InjectedFault
})

#: the env var carrying a process-wide plan (JSON: {"seed": s, "rules": [...]}
#: or a bare rule list)
ENV_VAR = "PSDS_FAULT_PLAN"


@dataclass(frozen=True)
class FaultRule:
    """One deterministic trigger: fire ``kind`` at ``site``.

    nth:     1-based site hit at which the rule first fires.
    count:   how many times it may fire in total (0/negative = unlimited).
    every:   after the first firing, fire again every ``every`` hits.
    p:       probabilistic arm instead of ``nth``/``every`` — each hit
             fires with probability ``p`` drawn from the plan's seeded
             RNG (still deterministic for a fixed plan seed and hit
             order); ``count`` caps it the same way.
    delay_s: sleep length for ``kind='delay'``.
    """

    site: str
    kind: str
    nth: int = 1
    count: int = 1
    every: int = 1
    p: Optional[float] = None
    delay_s: float = 0.05

    def __post_init__(self) -> None:
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"sites are {sorted(SITES)}")
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"kinds are {sorted(KINDS)}")
        if self.nth < 1:
            raise ValueError(f"nth is 1-based, got {self.nth}")
        if self.every < 1:
            raise ValueError(f"every must be >= 1, got {self.every}")

    def to_dict(self) -> dict:
        d = {"site": self.site, "kind": self.kind, "nth": self.nth,
             "count": self.count, "every": self.every,
             "delay_s": self.delay_s}
        if self.p is not None:
            d["p"] = self.p
        return d

    def _matches(self, hit: int, fired: int, rng: random.Random) -> bool:
        """Pure trigger check for the ``hit``-th visit (1-based)."""
        if self.count > 0 and fired >= self.count:
            return False
        if self.p is not None:
            return rng.random() < self.p
        return hit >= self.nth and (hit - self.nth) % self.every == 0


class FaultPlan:
    """An armed, thread-safe set of :class:`FaultRule` s.

        plan = FaultPlan([FaultRule("server.dispatch", "thread_death")])
        with plan:
            ...exercise the stack...
        assert plan.fired("server.dispatch") == 1

    Arming is process-global (the sites consult one active plan); plans
    nest LIFO so a test helper may arm its own plan inside another.
    ``hits(site)``/``fired(site)`` expose the bookkeeping for tests to
    assert the fault actually happened — a chaos test that passes
    because its fault never fired is not a chaos test.
    """

    def __init__(self, rules: Iterable, *, seed: int = 0) -> None:
        self.rules = tuple(
            r if isinstance(r, FaultRule) else FaultRule(**dict(r))
            for r in rules
        )
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._lock = new_lock("faults.plan")
        self._hits: dict[str, int] = {}
        self._fired_by_rule: dict[int, int] = {}
        self._fired_by_site: dict[str, int] = {}

    # ------------------------------------------------------------- matching
    def draw(self, site: str) -> Optional[FaultRule]:
        """Count one hit at ``site``; return the firing rule, if any.

        First matching rule wins (rule order is precedence)."""
        with self._lock:
            hit = self._hits.get(site, 0) + 1
            self._hits[site] = hit
            for i, rule in enumerate(self.rules):
                if rule.site != site:
                    continue
                if rule._matches(hit, self._fired_by_rule.get(i, 0),
                                 self._rng):
                    self._fired_by_rule[i] = self._fired_by_rule.get(i, 0) + 1
                    self._fired_by_site[site] = (
                        self._fired_by_site.get(site, 0) + 1
                    )
                    return rule
        return None

    # -------------------------------------------------------- observability
    def hits(self, site: Optional[str] = None) -> int:
        with self._lock:
            if site is not None:
                return self._hits.get(site, 0)
            return sum(self._hits.values())

    def fired(self, site: Optional[str] = None) -> int:
        with self._lock:
            if site is not None:
                return self._fired_by_site.get(site, 0)
            return sum(self._fired_by_site.values())

    # ---------------------------------------------------------------- wire
    def to_json(self) -> str:
        return json.dumps({"seed": self.seed,
                           "rules": [r.to_dict() for r in self.rules]})

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        data = json.loads(text)
        if isinstance(data, list):
            data = {"rules": data}
        return cls(data.get("rules", ()), seed=data.get("seed", 0))

    @classmethod
    def from_env(cls, environ=None) -> Optional["FaultPlan"]:
        """The ``PSDS_FAULT_PLAN`` plan, or None when the var is unset."""
        text = (os.environ if environ is None else environ).get(ENV_VAR)
        if not text:
            return None
        return cls.from_json(text)

    # ---------------------------------------------------------- arm/disarm
    def __enter__(self) -> "FaultPlan":
        from . import runtime

        runtime.arm(self)
        return self

    def __exit__(self, *exc) -> None:
        from . import runtime

        runtime.disarm(self)
