"""One table for every typed ``retry_ms`` hint the serving plane emits.

Before this module the backpressure constants were scattered through
``service/server.py`` (and the sharding plane) as magic numbers — 20 ms
at the reshard-freeze sites, 50 ms at capability issuance, 100 ms on a
standby refusal, 200 ms while draining.  :class:`BackpressurePolicy`
centralizes them behind named sites so

* tests can **pin** a site (``policy.set("throttle", 5)``) instead of
  monkeypatching call sites, and
* the autopilot's shed arm (docs/AUTOPILOT.md) can **scale** every hint
  multiplicatively with observed queue depth (``policy.set_scale(4.0)``)
  before the watchdog ever fires — clients already honor whatever
  ``retry_ms`` rides the refusal, so deeper backoff needs zero protocol
  changes.

The table is immutable-by-default: a server constructs its own policy,
defaults match the historical constants exactly, and ``scale == 1.0``
keeps every hint bit-identical to the pre-table behavior (the
zero-cost-when-disabled rail).  Reads are a dict lookup + one multiply;
no lock — the scale is a single float assignment (atomic in CPython)
and a momentarily stale hint is harmless backpressure jitter.
"""

from __future__ import annotations

#: historical per-site retry hints in milliseconds; keys are the typed
#: refusal families in service/server.py + sharding/ (docs/SERVICE.md)
DEFAULT_RETRY_MS = {
    "reshard_freeze": 20,      # barrier freezing/draining; come right back
    "reshard_conflict": 50,    # a barrier is already in flight
    "capability_issue": 50,    # transient issuance refusal
    "capability_stale": 20,    # grant superseded mid-issue
    "standby": 100,            # data op at a hot standby
    "throttle": 20,            # in-flight span past max_inflight
    "draining": 200,           # graceful shutdown in progress
    "tenant_admission": 50,    # tenant creation/burst quota
    "tenant_ranks": 100,       # tenant at its max_ranks quota
    "stream_append": 25,       # injected/failed APPEND; replay dedupes
    "horizon_gate": 25,        # horizon not appended / advance pending
    "wrong_shard": 25,         # re-route via the attached shard map
    "wrong_cell": 25,          # re-route via the attached cell directory
}

#: shed-arm ceiling: scaled hints never exceed this (a runaway controller
#: must not park clients for minutes)
MAX_RETRY_MS = 5_000


class BackpressurePolicy:
    """Named ``retry_ms`` table with one multiplicative shed scale."""

    __slots__ = ("_table", "_scale")

    def __init__(self, overrides=None, scale: float = 1.0) -> None:
        self._table = dict(DEFAULT_RETRY_MS)
        for site, ms in (overrides or {}).items():
            self.set(site, ms)
        self._scale = 1.0
        self.set_scale(scale)

    def retry_ms(self, site: str) -> int:
        """The hint for ``site``, shed-scaled and clamped to
        [1, MAX_RETRY_MS].  Unknown sites raise — a typo here would
        silently un-pace a refusal path."""
        base = self._table[site]
        return max(1, min(MAX_RETRY_MS, int(round(base * self._scale))))

    def set(self, site: str, ms: int) -> None:
        """Pin one site's base hint (tests; operator overrides)."""
        if site not in DEFAULT_RETRY_MS:
            raise KeyError(f"unknown backpressure site {site!r}; sites "
                           f"are {sorted(DEFAULT_RETRY_MS)}")
        self._table[site] = int(ms)

    def set_scale(self, factor: float) -> float:
        """Set the multiplicative shed factor (autopilot's load-shedding
        arm).  Clamped to [1, 256]; returns the applied value."""
        self._scale = max(1.0, min(256.0, float(factor)))
        return self._scale

    @property
    def scale(self) -> float:
        return self._scale

    def report(self) -> dict:
        """Observability: the effective table (post-scale) + the scale."""
        return {"scale": self._scale,
                "retry_ms": {s: self.retry_ms(s) for s in self._table}}
