"""``FleetSim``: thousands of simulated ranks against the real autopilot.

A copy of the JAX package's ``fleetsim/fleet.py``.

The simulator is a *harness*, not a model of the policy: every decision
is taken by the real :class:`~..autopilot.policy.AutopilotPolicy`, shed
pacing rides a real :class:`~..service.backpressure.BackpressurePolicy`
(the same named ``retry_ms`` table a live server constructs), and every
structural move composes the real :class:`~..sharding.ShardMap`
``split``/``merged``/``migrated`` transforms — the exact code a live
:class:`~..sharding.ShardPlane` commits through its two-phase barrier.
No sockets, no threads: given the same metric snapshots the decisions
and map transitions are bit-identical to a live plane's
(tests/test_fleetsim.py asserts this against real servers).

What *is* modeled (docs/SIMULATOR.md "Fluid window model"):

* per-shard offered load: the workload's per-rank demand over the
  shard's rank slice, divided by the advertised transport ``batch``,
  plus the retry backlog carried from the previous window;
* per-shard capacity: ``max_inflight`` service lanes, each taking one
  sampled service time (``rpc`` latency + regen cost amortized over
  the batch + a group-commit share of ``wal_fsync``);
* throttling: offered load beyond capacity is refused; a refused
  client sits out the shed-scaled ``retry_ms("throttle")`` hint, so a
  fraction ``retry_ms / window_ms`` of the excess evaporates (paced
  clients genuinely demand less) and the rest returns as backlog;
* tail latency: the regen p99 grows with utilization
  (``0.2 / (1 - u)`` past 80 %), which is what arms the policy's
  split gate exactly like a congested live shard would;
* structural moves: a sampled ``barrier`` latency freezes the involved
  shards for that fraction of the next window — splits are not free.

Scenario fault injection (``inject_surge`` / ``inject_slow_shard``)
passes through the ``sim.inject`` fault site; every event dispatch
passes through ``sim.event`` (events.py) — both registered in
faults/plan.py so chaos plans can perturb the simulator itself.
"""

from __future__ import annotations

from typing import Optional

from .. import faults as F
from ..autopilot.policy import AutopilotPolicy, Decision, PolicyConfig
from ..federation.directory import CellDirectory
from ..service.backpressure import BackpressurePolicy
from ..sharding.shardmap import ShardMap
from ..utils.metrics import MetricsRegistry
from .clock import SimClock
from .events import EventLoop
from .latency import LatencyModel, RegenCostModel
from .trace import DecisionTrace
from .workload import Workload


class FleetSim:
    """One simulated deployment: world ranks over n_shards shards.

        sim = FleetSim(world=5000, n_shards=4, n=5000 << 20,
                       workload=workload.hotspot(...), seed=7)
        sim.run(ticks=40)
        sim.trace.decision_log()      # byte-identical per (scenario, seed)
    """

    def __init__(self, *, world: int, n_shards: int, n: int,
                 workload: Workload, seed: int = 0,
                 config: Optional[PolicyConfig] = None,
                 policy: Optional[AutopilotPolicy] = None,
                 latency: Optional[LatencyModel] = None,
                 regen_cost: Optional[RegenCostModel] = None,
                 interval_s: float = 1.0, batch0: int = 1024,
                 backend: str = "native",
                 sampling_mode: Optional[str] = None,
                 cells: Optional[tuple] = None) -> None:
        self.world = int(world)
        self.n = int(n)
        self.workload = workload
        self.seed = int(seed)
        self.interval_s = float(interval_s)
        self.clock = SimClock()
        self.registry = MetricsRegistry()
        self.loop = EventLoop(self.clock, registry=self.registry)
        self.map = ShardMap.for_world(self.world, int(n_shards))
        self.backpressure = BackpressurePolicy()
        self.policy = policy if policy is not None else AutopilotPolicy(
            config, clock=self.clock, seed=self.seed)
        self.latency = latency if latency is not None \
            else LatencyModel(seed=self.seed)
        self.regen_cost = regen_cost if regen_cost is not None \
            else RegenCostModel()
        self.trace = DecisionTrace()
        #: live knobs the tune arm actuates (a real plane's servers
        #: advertise these through WELCOME/heartbeat)
        self.batch = int(batch0)
        self.max_inflight = int(self.policy.config.min_inflight)
        self.backend = str(backend)
        #: non-uniform sampling mode of the simulated workload
        #: (docs/SAMPLING.md) — shifts the regen cost lines (the dedup
        #: fold is host-side work) and the priors' workload key
        self.sampling_mode = sampling_mode
        #: federated overlay (docs/FEDERATION.md): a (home, dr) cell
        #: pair builds a real CellDirectory over synthetic addresses so
        #: the cell-kill scenario flips the SAME versioned value object
        #: a live federation installs at promotion
        self.cell_directory: Optional[CellDirectory] = None
        self.cell: Optional[str] = None
        if cells is not None:
            home_c, dr_c = str(cells[0]), str(cells[1])
            self.cell_directory = CellDirectory(
                {home_c: (f"sim-{home_c}", 0), dr_c: (f"sim-{dr_c}", 0)},
                default=home_c, dr={home_c: dr_c, dr_c: home_c})
            self.cell = home_c
        self.ticks = 0
        self.window_stats: dict = {}   # sid -> last window's fluid state
        self._backlog: dict = {}       # sid -> carried retry backlog (rpcs)
        self._frozen: dict = {}        # sid -> barrier freeze fraction
        self._demand_mult: list = []   # [(from_t, factor)] surge overlays
        self._slow: dict = {}          # sid -> service-time multiplier
        self.loop.after(self.interval_s, self._tick, label="tick")

    # ------------------------------------------------------------ running
    def run(self, ticks: int) -> "FleetSim":
        """Advance the simulation by ``ticks`` policy windows."""
        self.loop.run_until(self.clock() + float(ticks) * self.interval_s)
        return self

    @property
    def per_rank(self) -> int:
        return max(1, self.n // self.world)

    # ---------------------------------------------------------- injection
    def inject_surge(self, at_s: float, factor: float) -> None:
        """Schedule a fleet-wide demand step to ``factor``× at ``at_s``."""
        self.loop.at(at_s, lambda: self._inject(
            lambda: self._demand_mult.append((float(at_s), float(factor)))),
            label="inject:surge")

    def inject_slow_shard(self, at_s: float, shard_id: int,
                          factor: float) -> None:
        """Schedule shard ``shard_id``'s service time to stretch by
        ``factor``× at ``at_s`` (a degraded host under that shard)."""
        sid = int(shard_id)
        self.loop.at(at_s, lambda: self._inject(
            lambda: self._slow.__setitem__(sid, float(factor))),
            label="inject:slow_shard")

    def inject_cell_kill(self, at_s: float) -> None:
        """Schedule the DR drill at ``at_s``: the whole home cell dies —
        the directory flips every tenant to the DR partner in one
        version bump (``CellDirectory.flip_cell``, the exact transform a
        live ``Federation.promote`` installs), the fleet re-dials there,
        and one sampled failover barrier freezes EVERY shard's next
        window (clients ladder + mirrors promote; docs/FEDERATION.md)."""
        if self.cell_directory is None:
            raise RuntimeError(
                "cell-kill needs FleetSim(cells=(home, dr))")
        self.loop.at(at_s, lambda: self._inject(self._cell_kill),
                     label="inject:cell_kill")

    def _cell_kill(self) -> None:
        dead = self.cell
        to = self.cell_directory.dr_for(dead)
        if to is None:
            self.registry.inc("sim_actuation_errors")
            return
        self.cell_directory = self.cell_directory.flip_cell(dead, to)
        self.cell = to
        self._freeze(*self.live_shards())
        self.registry.inc("sim_cell_kills")

    def _inject(self, apply) -> None:
        try:
            F.fire("sim.inject")
        except F.InjectedThreadDeath:
            raise
        except Exception:  # lint: allow-broad-except(injected scenario fault dropped, counted)
            self.registry.inc("sim_inject_faults")
            return
        apply()
        self.registry.inc("sim_injected")

    # -------------------------------------------------------------- tick
    def _tick(self) -> None:
        now = self.clock()
        obs = self._observe(now)
        decisions = self.policy.decide(obs)
        actuated = [d for d in decisions if self._actuate(d)]
        self.ticks += 1
        self.registry.inc("sim_ticks")
        self.registry.inc("sim_decisions", len(actuated))
        extra = None
        if self.cell_directory is not None:
            extra = {"cell": self.cell,
                     "directory_version": self.cell_directory.version,
                     "directory_fingerprint":
                         self.cell_directory.fingerprint()}
        self.trace.append(
            tick=self.ticks, now=now, obs=obs, decisions=actuated,
            pstate=self.policy.state_dict(),
            map_fingerprint=self.map.fingerprint(),
            extra=extra)
        self.loop.after(self.interval_s, self._tick, label="tick")

    # ------------------------------------------------------------ observe
    def _observe(self, now: float) -> dict:
        """One windowed observation, shaped exactly like
        ``Autopilot._observe`` builds it from live registries."""
        window_ms = self.interval_s * 1e3
        mult = 1.0
        for t0, f in self._demand_mult:
            if now >= t0:
                mult *= f
        shards: dict = {}
        total_served = total_throttled = 0
        frozen, self._frozen = self._frozen, {}
        for sid, (lo, hi) in enumerate(self.map.slices):
            if hi <= lo:
                continue
            demand = mult * sum(self.workload.rate(r, now)
                                for r in range(lo, hi))
            rpc_ms = self.latency.sample("rpc") * self._slow.get(sid, 1.0)
            wal_ms = self.latency.sample("wal_fsync")
            regen_noise = self.latency.sample("regen") \
                / self.latency.p50("regen")
            regen_ms = self.regen_cost.estimate_ms(
                self.backend, self.per_rank,
                sampling_mode=self.sampling_mode) * regen_noise
            svc_ms = rpc_ms + regen_ms * self.batch / self.per_rank \
                + 0.1 * wal_ms
            cap_w = self.max_inflight * window_ms / svc_ms \
                * (1.0 - frozen.get(sid, 0.0))
            offered = demand * self.interval_s / self.batch \
                + self._backlog.get(sid, 0.0)
            served = min(offered, cap_w)
            excess = offered - served
            retry_frac = min(
                1.0, self.backpressure.retry_ms("throttle") / window_ms)
            self._backlog[sid] = excess * (1.0 - retry_frac)
            util = offered / cap_w if cap_w > 0.0 else 1.0
            congestion = max(1.0, 0.2 / max(0.05, 1.0 - min(util, 0.95)))
            tail = self.latency.p99("regen") / self.latency.p50("regen")
            p99_ms = regen_ms * tail * congestion
            served_i, throttled_i = int(served + 0.5), int(excess + 0.5)
            total_served += served_i
            total_throttled += throttled_i
            shards[sid] = {"served": served_i, "lo": int(lo),
                           "hi": int(hi), "ranks": int(hi - lo),
                           "p99_ms": float(p99_ms)}
            self.window_stats[sid] = {
                "offered": offered, "capacity": cap_w, "util": util,
                "served": served_i, "throttled": throttled_i,
                "svc_ms": svc_ms, "p99_ms": p99_ms,
            }
        for sid in list(self._backlog):
            if sid not in shards:
                del self._backlog[sid]
        for sid in list(self.window_stats):
            if sid not in shards:
                del self.window_stats[sid]
        obs = {"now": now, "window_s": self.interval_s,
               "served": total_served, "throttled": total_throttled,
               "batch": int(self.batch),
               "max_inflight": int(self.max_inflight),
               "shards": shards, "workload": self.workload.key}
        if self.policy.config.backend_pick:
            cand, gain_pct, _ = self.regen_cost.pick(
                self.per_rank, sampling_mode=self.sampling_mode)
            obs["backend_current"] = self.backend
            obs["backend_candidate"] = cand
            obs["backend_gain_pct"] = gain_pct
        return obs

    # ------------------------------------------------------------ actuate
    def _actuate(self, d: Decision) -> bool:
        """Apply one decision to the simulated plane; mirrors
        ``Autopilot._actuate`` — a failed move is counted and NOT
        recorded, so the trace (like the live WAL) only ever replays
        things that happened."""
        try:
            if d.kind == "tune":
                if d.args.get("batch_hint") is not None:
                    self.batch = max(1, int(d.args["batch_hint"]))
                if d.args.get("max_inflight") is not None:
                    self.max_inflight = max(1, int(d.args["max_inflight"]))
                self.registry.inc("sim_tunes")
            elif d.kind == "shed":
                self.backpressure.set_scale(float(d.args["scale"]))
                self.registry.inc("sim_sheds")
            elif d.kind == "pick_backend":
                self.backend = str(d.args["backend"])
                self.registry.inc("sim_backend_picks")
            elif d.kind == "split":
                old = self.map
                self.map = old.split(int(d.target))
                new_sid = len(self.map.slices) - 1
                half = self._backlog.get(int(d.target), 0.0) / 2.0
                self._backlog[int(d.target)] = half
                self._backlog[new_sid] = half
                self._freeze(int(d.target), new_sid)
                self.registry.inc("sim_splits")
            elif d.kind == "merge":
                into, frm = int(d.args["into"]), int(d.args["frm"])
                self.map = self.map.merged(into, frm)
                self._backlog[into] = self._backlog.get(into, 0.0) \
                    + self._backlog.pop(frm, 0.0)
                self._freeze(into)
                self.registry.inc("sim_merges")
            elif d.kind == "migrate":
                frm, to = int(d.args["frm"]), int(d.args["to"])
                self.map = self.map.migrated(frm, to,
                                             int(d.args["count"]))
                self._freeze(frm, to)
                self.registry.inc("sim_migrations")
            elif d.kind == "drill":
                # no standby in the fluid model; a drill is a no-op tick
                self.registry.inc("sim_drills")
            else:
                self.registry.inc("sim_actuation_errors")
                return False
        except F.InjectedThreadDeath:
            raise
        except Exception:  # lint: allow-broad-except(failed sim actuation is counted, not fatal)
            self.registry.inc("sim_actuation_errors")
            return False
        return True

    def _freeze(self, *sids) -> None:
        """A structural barrier: the involved shards lose a sampled
        ``barrier``-latency fraction of their next window's capacity."""
        frac = min(1.0, self.latency.sample("barrier")
                   / (self.interval_s * 1e3))
        for sid in sids:
            self._frozen[int(sid)] = max(
                self._frozen.get(int(sid), 0.0), frac)

    # ------------------------------------------------------------- status
    def max_util(self) -> float:
        """The hottest live shard's last-window utilization."""
        if not self.window_stats:
            return 0.0
        return max(s["util"] for s in self.window_stats.values())

    def live_shards(self) -> list:
        return [sid for sid, (lo, hi) in enumerate(self.map.slices)
                if hi > lo]

    def status(self) -> dict:
        out = {}
        if self.cell_directory is not None:
            out["cell"] = self.cell
            out["directory_version"] = self.cell_directory.version
        return {
            **out,
            "now": self.clock(),
            "ticks": self.ticks,
            "map": self.map.to_wire(),
            "batch": self.batch,
            "max_inflight": self.max_inflight,
            "backend": self.backend,
            "shed_scale": self.backpressure.scale,
            "max_util": self.max_util(),
            "policy": self.policy.state_dict(),
        }
