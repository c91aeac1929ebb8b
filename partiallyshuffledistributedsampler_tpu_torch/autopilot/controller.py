"""``Autopilot``: the per-deployment closed-loop controller.

A copy of the JAX package's ``autopilot/controller.py``.

One controller owns one deployment handle — a single
:class:`~..service.IndexServer` or a whole
:class:`~..sharding.ShardPlane` — and runs the observe → decide →
actuate loop (docs/AUTOPILOT.md):

* **observe**: sample every server registry's ``snapshot()`` and diff
  against the previous tick (``registry_delta``), producing a windowed
  observation of served batches, throttle refusals, regen cost,
  replication lag, and per-shard load.
* **decide**: hand the observation to the deterministic
  :class:`~.policy.AutopilotPolicy` behind the ``autopilot.decide``
  fault site — an injected fault is one skipped tick, counted in
  ``autopilot_decide_errors``, never a crash.
* **actuate**: knob tunes ride ``IndexServer.set_autopilot_knobs`` (the
  additive WELCOME/heartbeat fields), sheds scale the shared
  :class:`~..service.backpressure.BackpressurePolicy`, structural moves
  call the plane's ``split_shard``/``merge_shards``/``migrate_ranks``,
  and drills time ``standby._try_promote(force=True)`` into
  ``autopilot_drill_ms`` + the client-visible ``failover_ms``.

Every actuated decision is WAL-logged as an additive ``autopilot``
record carrying the policy's ``state_dict()``, so the standby mirrors
the controller's trajectory and a promoted standby's own controller
resumes it via ``IndexServer.autopilot_state()``.  A deployment with no
controller attached pays nothing: no thread, no protocol bytes, one
boolean per heartbeat reply.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from .. import faults as F
from .. import telemetry
from ..utils.metrics import histogram_delta, registry_delta
from .policy import AutopilotPolicy, Decision, PolicyConfig
from .priors import workload_key


class Autopilot:
    """Observe → decide → actuate loop for one deployment (module doc)."""

    #: the live autotune probe times both backends at two sizes
    #: (seconds, the kernels' build included);
    #: below this many per-rank samples the pick cannot matter enough
    #: to amortize it, so the backend arm stays silent
    BACKEND_PROBE_MIN_SAMPLES = 1 << 16

    def __init__(self, server=None, *, plane=None, standby=None,
                 policy: Optional[AutopilotPolicy] = None,
                 config: Optional[PolicyConfig] = None,
                 interval_s: float = 1.0, clock=None,
                 backend_probe=None, observe=None) -> None:
        if (server is None) == (plane is None):
            raise ValueError(
                "Autopilot drives exactly one deployment: pass server= "
                "OR plane=")
        self.plane = plane
        self._servers = [server] if server is not None else None
        self.standby = standby
        self.interval_s = float(interval_s)
        self._clock = clock if clock is not None else time.monotonic
        self.policy = policy if policy is not None else AutopilotPolicy(
            config, clock=self._clock)
        #: optional cost-probe override: ``fn(num_samples) ->
        #: (backend, info)`` in ``utils.autotune.pick_backend``'s shape
        #: (fleetsim's RegenCostModel.pick adapts directly; tests and
        #: the sim/real parity suite inject it to skip the card probe)
        self._backend_probe = backend_probe
        #: optional observation override: a callable returning the next
        #: obs dict, or None when the replayed snapshot stream is
        #: exhausted (docs/SIMULATOR.md "Replay semantics") — trace
        #: replays feed a live plane the exact snapshots a simulated
        #: run observed
        self._observe_fn = observe
        inherited = self._wal_server().autopilot_state()
        if inherited is not None:
            # a promoted standby hands its mirrored decision state to
            # the new controller: the trajectory RESUMES, not restarts
            self.policy.load_state_dict(inherited)
            # the mirrored knobs were re-applied by WAL replay, but the
            # shed scale lives in each server's BackpressurePolicy —
            # restore it too, or a failover would silently un-shed a
            # loaded fleet
            scale = float(self.policy.state_dict().get("scale", 1.0))
            if scale != 1.0:
                for srv in self.servers():
                    srv.backpressure.set_scale(scale)
        #: the registry the autopilot's own metrics ride — the lead
        #: server's, so one METRICS poll shows decisions next to load
        self.registry = self._wal_server().metrics.registry
        self._prev: dict = {}       # per-server snapshot from last tick
        self._prev_t: Optional[float] = None
        self._backend_candidate: Optional[str] = None
        self._backend_gain: Optional[float] = None
        self._last_workload: Optional[str] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------- topology
    def servers(self) -> list:
        return list(self.plane.shards) if self.plane is not None \
            else list(self._servers)

    def _wal_server(self):
        """Where decisions are WAL-logged (and metrics ride): the single
        server, or the plane's lead shard."""
        return self._servers[0] if self._servers is not None \
            else self.plane.shards[0]

    # ---------------------------------------------------------- lifecycle
    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("autopilot already started")
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="psds-autopilot", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except F.InjectedThreadDeath:
                raise
            except Exception:  # lint: allow-broad-except(control loop must outlive one bad tick)
                self.registry.inc("autopilot_decide_errors")

    def __enter__(self) -> "Autopilot":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # --------------------------------------------------------------- tick
    def tick(self) -> list:
        """One observe → decide → actuate pass; returns the actuated
        decisions.  Callable directly (tests drive it under a fake
        clock) or from the ``start()`` thread."""
        t0 = time.perf_counter()
        try:
            F.fire("autopilot.decide")
        except F.InjectedThreadDeath:
            raise
        except Exception:  # lint: allow-broad-except(injected decide fault; tick skipped)
            # an injected decide fault is one skipped tick: the window
            # folds into the next delta, no decision is lost for good
            self.registry.inc("autopilot_decide_errors")
            return []
        obs = self._observe() if self._observe_fn is None \
            else self._observe_fn()
        if obs is None:
            # an injected observation stream (trace replay) ran dry
            return []
        self._last_workload = obs.get("workload")
        with telemetry.span("autopilot.tick", served=obs.get("served", 0)):
            decisions = self.policy.decide(obs)
            actuated = []
            for d in decisions:
                if self._actuate(d):
                    self._log(d)
                    actuated.append(d)
        self.registry.inc("autopilot_decisions", len(actuated))
        self.registry.histogram("autopilot_tick_ms").observe(
            (time.perf_counter() - t0) * 1e3)
        return actuated

    # ------------------------------------------------------------ observe
    def _observe(self) -> dict:
        now = self._clock()
        window_s = (now - self._prev_t) if self._prev_t is not None \
            else self.interval_s
        self._prev_t = now
        obs = {"now": now, "window_s": max(1e-6, float(window_s)),
               "served": 0, "throttled": 0}
        shards: dict = {}
        for srv in self.servers():
            snap = srv.metrics.registry.snapshot()
            delta = registry_delta(snap, self._prev.get(id(srv)))
            self._prev[id(srv)] = snap
            served = int(delta["counters"].get("batches_served", 0))
            obs["served"] += served
            obs["throttled"] += int(delta["counters"].get("throttled", 0))
            if self.plane is not None:
                lo, hi = srv.shard_map.ranks(srv.shard_id)
                h = delta["histograms"].get("epoch_regen_ms") or {}
                shards[srv.shard_id] = {
                    "served": served, "lo": int(lo), "hi": int(hi),
                    "ranks": int(hi - lo),
                    "p99_ms": float(h.get("p99_ms", 0.0)),
                }
        if shards:
            obs["shards"] = shards
        lead = self._wal_server()
        obs["max_inflight"] = int(lead.max_inflight)
        bh = lead._batch_hint
        if bh is None:
            # no hint tuned yet: the live leases carry what clients
            # actually negotiated at HELLO — start from there
            with lead._lock:
                sizes = [int(l.get("batch") or 0)
                         for l in lead._leases.values()]
            bh = max(sizes) if any(sizes) else None
        if bh is not None:
            obs["batch"] = int(bh)
        lag = self._repl_lag_p95()
        if lag is not None:
            obs["repl_lag_p95_ms"] = lag
        obs["workload"] = workload_key(lead.spec)
        if self.policy.config.backend_pick:
            cand = self._pick_backend(lead)
            if cand is not None:
                obs["backend_current"] = getattr(
                    lead.spec, "backend", None)
                obs["backend_candidate"] = cand
                if self._backend_gain is not None:
                    obs["backend_gain_pct"] = float(self._backend_gain)
        return obs

    def _repl_lag_p95(self) -> Optional[float]:
        """Windowed replication-lag p95 from whichever side observes it
        (the feed's histogram rides the primary's registry)."""
        for side in (self._wal_server(), self.standby):
            if side is None:
                continue
            reg = side.metrics.registry
            if "repl_lag_ms" not in reg.histogram_states():
                continue
            cur = reg.histogram("repl_lag_ms").snapshot()
            prev = self._prev.get(("repl_lag", id(side)))
            self._prev[("repl_lag", id(side))] = cur
            d = histogram_delta(cur, prev)
            if d["count"] > 0:
                return float(d["p95_ms"])
        return None

    def _pick_backend(self, lead) -> Optional[str]:
        """Resolve the regen backend from the observed cost model (one
        probe per controller, memoized); advisory: the pick is logged +
        exposed via ``status()``, the training side adopts it at its
        next spec construction.  Without an injected ``backend_probe``
        the live autotune probe (utils/autotune.py) runs — but only for
        workloads past ``BACKEND_PROBE_MIN_SAMPLES`` per rank, because
        the probe takes seconds on the card and a toy spec can never
        win enough regen time back."""
        if self._backend_candidate is not None:
            return self._backend_candidate
        per_rank = max(1, int(lead.spec.n or 0)
                       // max(1, int(lead.spec.world)))
        probe = self._backend_probe
        if probe is None:
            if per_rank < self.BACKEND_PROBE_MIN_SAMPLES:
                return None
            from ..utils.autotune import pick_backend as probe
        cand, info = probe(per_rank)
        self._backend_candidate = cand
        if info and info.get("est_host_ms") is not None \
                and info.get("est_device_ms") is not None:
            worse = max(float(info["est_host_ms"]),
                        float(info["est_device_ms"]))
            best = min(float(info["est_host_ms"]),
                       float(info["est_device_ms"]))
            if worse > 0.0:
                self._backend_gain = 100.0 * (worse - best) / worse
        return self._backend_candidate

    # ------------------------------------------------------------ actuate
    def _actuate(self, d: Decision) -> bool:
        """Apply one decision; False (after counting the error) if the
        actuation failed — a failed move is NOT WAL-logged, so replay
        never re-applies something that never happened."""
        try:
            if d.kind == "tune":
                for srv in self.servers():
                    srv.set_autopilot_knobs(
                        max_inflight=d.args.get("max_inflight"),
                        batch_hint=d.args.get("batch_hint"))
                self.registry.inc("autopilot_tunes")
            elif d.kind == "shed":
                for srv in self.servers():
                    srv.backpressure.set_scale(float(d.args["scale"]))
                self.registry.inc("autopilot_sheds")
            elif d.kind == "pick_backend":
                self.registry.inc("autopilot_backend_picks")
            elif d.kind == "split":
                with telemetry.span("autopilot.split", shard=d.target):
                    self.plane.split_shard(int(d.target))
                self.registry.inc("autopilot_splits")
            elif d.kind == "merge":
                with telemetry.span("autopilot.merge", **d.args):
                    self.plane.merge_shards(int(d.args["into"]),
                                            int(d.args["frm"]))
                self.registry.inc("autopilot_merges")
            elif d.kind == "migrate":
                with telemetry.span("autopilot.migrate", **d.args):
                    self.plane.migrate_ranks(int(d.args["frm"]),
                                             int(d.args["to"]),
                                             int(d.args["count"]))
                self.registry.inc("autopilot_migrations")
            elif d.kind == "drill":
                t0 = time.perf_counter()
                promoted = self.standby is not None \
                    and self.standby._try_promote(force=True)
                if not promoted:
                    self.registry.inc("autopilot_decide_errors")
                    return False
                ms = (time.perf_counter() - t0) * 1e3
                self.registry.histogram("autopilot_drill_ms").observe(ms)
                self.registry.histogram("failover_ms").observe(ms)
                self.registry.inc("autopilot_drills")
            else:
                self.registry.inc("autopilot_decide_errors")
                return False
        except F.InjectedThreadDeath:
            raise
        except Exception:  # lint: allow-broad-except(failed actuation is counted, not fatal)
            self.registry.inc("autopilot_decide_errors")
            return False
        telemetry.event("autopilot_decision", seq=d.seq, kind=d.kind,
                        target=d.target, reason=d.reason)
        return True

    def _log(self, d: Decision) -> None:
        """One additive ``autopilot`` WAL record per actuated decision:
        the decision itself plus the policy's full post-decision state,
        so the mirror needs only the NEWEST record to resume."""
        self._wal_server()._repl_append(
            "autopilot", seq=int(d.seq), kind=d.kind, target=d.target,
            args=dict(d.args), reason=d.reason,
            knobs=(dict(d.args) if d.kind == "tune" else None),
            workload=self._last_workload,
            pstate=self.policy.state_dict())

    # ------------------------------------------------------------- status
    def status(self) -> dict:
        """Operator view: the policy state plus effective knob values."""
        lead = self._wal_server()
        return {
            "policy": self.policy.state_dict(),
            "max_inflight": int(lead.max_inflight),
            "batch_hint": lead._batch_hint,
            "backpressure": lead.backpressure.report(),
        }
