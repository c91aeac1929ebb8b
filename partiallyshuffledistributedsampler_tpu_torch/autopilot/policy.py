"""The autopilot's deterministic policy engine (docs/AUTOPILOT.md).

A copy of the JAX package's ``autopilot/policy.py`` (pure standard
library): one observation stream gives the same decisions in both
packages.

``AutopilotPolicy`` is a pure decision function over windowed
observations: same state + same observation → same decisions, on every
replay.  Nothing here reads a wall clock (``clock=`` is injected), draws
randomness at decision time, or touches the deployment — the controller
(:mod:`.controller`) observes and actuates; the policy only *decides*.
That purity is what makes decisions WAL-replayable: a promoted standby
loads the last logged ``state_dict()`` and continues the exact decision
trajectory the dead primary was on.

The rules are threshold/hysteresis arms, evaluated in a fixed order
(knobs → shed → shard map → drill) so a tick's decision list is itself
deterministic:

* ``tune``: double/halve the advertised transport batch toward a target
  RPC rate; widen ``max_inflight`` when the window saw throttle
  refusals, narrow it back once the stream has been calm for a while.
* ``shed``: scale every ``retry_ms`` hint (the typed-backpressure
  table) up ×2 while refusals persist, decay ÷2 when calm.
* ``split`` / ``merge`` / ``migrate``: compare per-shard served
  volumes; a shard serving ``hot_factor``× the mean with a slow p99
  splits, two rank-adjacent shards both under ``cold_factor``× merge,
  and a hot/cold adjacent imbalance migrates a quarter of the hot
  shard's ranks.  Structural moves share one cooldown.
* ``pick_backend``: adopt the regen backend the measured cost model
  prefers, when the modeled gain clears ``backend_min_gain_pct``.
* ``drill``: when replication lag is clean and nothing structural
  happened this tick, promote the standby to measure a real failover.

**Predictive mode** (``predictive=True``, docs/AUTOPILOT.md): the
policy keeps a bounded window history in its state and fits a
least-squares slope over it; the tune arm then jumps every ladder rung
the forecast justifies in one decision, and the shed/split arms act on
the forecast load — before saturation, not after.  **Priors**: after
``prior_confirm_ticks`` knob-quiet serving ticks the converged knobs
are recorded under the observation's ``workload`` key; they ride every
WAL record's ``pstate``, so a restarted deployment's first tick warm
starts straight to the confirmed knobs (fleetsim proves both loops,
tests/test_fleetsim.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class PolicyConfig:
    """Thresholds for every arm; defaults are deliberately calm."""

    # -- knob arm: transport batch sizing toward a target RPC rate
    target_rpc_per_s: float = 50.0   # fewer, larger batches above this
    min_batch: int = 1024
    max_batch: int = 1 << 20
    # -- knob arm: in-flight window
    min_inflight: int = 2
    max_inflight: int = 64
    calm_ticks_to_narrow: int = 8    # throttle-free ticks before narrowing
    # -- shed arm
    shed_threshold: int = 4          # throttle refusals/window that shed
    max_shed_scale: float = 8.0
    # -- shard-map arm
    hot_factor: float = 2.0          # served > factor * mean → hot
    cold_factor: float = 0.25        # served < factor * mean → cold
    split_p99_ms: float = 20.0       # hot alone is not enough: p99 slow too
    min_shard_ranks: int = 2         # never split below this many ranks
    struct_cooldown_s: float = 5.0   # one structural move per cooldown
    # -- drill arm (off by default: a drill IS a real failover)
    drill_interval_s: Optional[float] = None
    drill_max_lag_ms: float = 50.0
    # -- backend arm (on by default: the controller gates the probe to
    #    workloads big enough to amortize it, and the margin below keeps
    #    marginal wins from flapping the training side's backend)
    backend_pick: bool = True
    backend_min_gain_pct: float = 10.0   # modeled gain needed to switch
    # -- predictive mode (docs/AUTOPILOT.md "Predictive mode"): forecast
    #    load from the slope over recent windows so tune/shed/split act
    #    BEFORE saturation; off by default — reactive behavior is the
    #    bit-compatible baseline
    predictive: bool = False
    forecast_windows: int = 4        # history length the slope fits over
    forecast_horizon_s: float = 3.0  # how far ahead the arms look
    # -- prior learning: after this many stable (knob-quiet, serving)
    #    ticks the current knobs become the workload's prior, riding
    #    every WAL record's pstate so a restarted deployment starts warm
    prior_confirm_ticks: int = 5


@dataclass(frozen=True)
class Decision:
    """One actuation the policy asks the controller for."""

    seq: int
    kind: str            # tune | shed | split | merge | migrate | drill
    #                    # | pick_backend
    target: Optional[int] = None     # shard id for split
    args: dict = field(default_factory=dict)
    reason: str = ""


class AutopilotPolicy:
    """Deterministic threshold policy (see module doc)."""

    def __init__(self, config: Optional[PolicyConfig] = None, *,
                 clock=None, seed: int = 0) -> None:
        self.config = config if config is not None else PolicyConfig()
        if clock is None:
            raise ValueError(
                "AutopilotPolicy needs an injected clock= (monotonic "
                "seconds); implicit wall clocks would make replay drift")
        self._clock = clock
        self.seed = int(seed)
        self._s = {
            "seq": 0,              # decisions emitted so far
            "batch_hint": None,    # last tuned transport batch
            "max_inflight": None,  # last tuned in-flight window
            "scale": 1.0,          # current shed scale
            "calm_ticks": 0,       # consecutive throttle-free ticks
            "last_struct_t": None,  # clock at the last split/merge/migrate
            "last_drill_t": None,
            "backend": None,       # adopted regen backend
            # bounded window history the predictive arms fit slopes
            # over: [[now, sample_rate, throttled, {sid: samples}], ...]
            # — volumes in SAMPLES (rate x batch), not rpcs, so a tune
            # that changes the batch does not read as a load collapse
            # (shard keys are strings so the state survives a JSON
            # round-trip through the WAL unchanged)
            "history": [],
            "priors": {},          # workload key -> confirmed knobs
            "stable_ticks": 0,     # knob-quiet serving ticks in a row
        }

    # ------------------------------------------------------------- replay
    def state_dict(self) -> dict:
        """JSON-safe decision state — what the ``autopilot`` WAL record
        carries, and what a promoted standby's controller loads."""
        return dict(self._s, seed=self.seed)

    def load_state_dict(self, d: dict) -> None:
        d = dict(d or {})
        self.seed = int(d.pop("seed", self.seed))
        for k in self._s:
            if k in d:
                self._s[k] = d[k]

    # ------------------------------------------------------------- decide
    def decide(self, obs: dict) -> list:
        """The tick's decisions, in actuation order.  ``obs`` is the
        controller's windowed delta (see ``Autopilot._observe``); every
        value is a plain number/dict so replays observe identically."""
        cfg = self.config
        out: list = []
        now = float(obs.get("now", self._clock()))
        window_s = max(1e-6, float(obs.get("window_s", 1.0)))

        served = int(obs.get("served", 0))
        throttled = int(obs.get("throttled", 0))
        rpc_rate = served / window_s
        shards = obs.get("shards") or {}
        live = {int(s): d for s, d in shards.items()
                if int(d.get("ranks", 0)) > 0}

        batch = int(obs.get("batch")
                    or self._s["batch_hint"] or cfg.min_batch)

        # ---- window history (the predictive arms' slope input) --------
        # volumes are recorded in SAMPLES (rpcs x batch): sample
        # throughput is invariant under the policy's own batch tunes,
        # so the slope tracks the WORKLOAD — a tune never reads as a
        # load collapse.  Forecasts convert back to rpc units at the
        # batch in force now.
        hist = list(self._s.get("history") or [])
        hist.append([now, rpc_rate * batch, throttled,
                     {str(s): int(d.get("served", 0)) * batch
                      for s, d in live.items()}])
        self._s["history"] = hist[-max(2, int(cfg.forecast_windows)):]
        f_rate = f_throttled = None
        f_served: dict = {}
        if cfg.predictive and len(self._s["history"]) >= 2:
            h = self._s["history"]
            f_rate = _forecast([(e[0], e[1]) for e in h],
                               cfg.forecast_horizon_s) / batch
            f_throttled = _forecast([(e[0], e[2]) for e in h],
                                    cfg.forecast_horizon_s)
            for sid in live:
                pts = [(e[0], e[3][str(sid)]) for e in h
                       if str(sid) in e[3]]
                if len(pts) >= 2:
                    f_served[sid] = _forecast(
                        pts, cfg.forecast_horizon_s) / batch

        # ---- knob arm -------------------------------------------------
        knobs: dict = {}
        wl = obs.get("workload")
        prior = (self._s.get("priors") or {}).get(str(wl)) \
            if wl is not None else None
        if prior and self._s["batch_hint"] is None:
            # warm start: a restarted deployment jumps straight to the
            # knobs a previous run confirmed for this workload instead
            # of re-climbing the doubling ladder
            knobs["batch_hint"] = int(prior["batch_hint"])
            if prior.get("max_inflight") is not None:
                knobs["max_inflight"] = int(prior["max_inflight"])
            self._s["batch_hint"] = knobs["batch_hint"]
            self._s["max_inflight"] = knobs.get(
                "max_inflight", self._s["max_inflight"])
            out.append(self._emit(
                "tune", args=knobs,
                reason=f"warm start from prior for workload {wl}"))
            knobs = {}
        else:
            eff_rate = f_rate if f_rate is not None else rpc_rate
            if cfg.predictive:
                # jump every ladder rung the forecast justifies in ONE
                # decision: rate scales as 1/batch at fixed sample
                # throughput, so the fixpoint batch is computable now
                nb, r = batch, eff_rate
                while served and r > cfg.target_rpc_per_s \
                        and nb < cfg.max_batch:
                    nb = min(cfg.max_batch, nb * 2)
                    r = eff_rate * batch / nb
                while served and r < cfg.target_rpc_per_s / 4 \
                        and nb > cfg.min_batch:
                    half = max(cfg.min_batch, nb // 2)
                    r2 = eff_rate * batch / half
                    if r2 > cfg.target_rpc_per_s:
                        break
                    nb, r = half, r2
                if nb != batch:
                    knobs["batch_hint"] = nb
            elif served and rpc_rate > cfg.target_rpc_per_s \
                    and batch < cfg.max_batch:
                knobs["batch_hint"] = min(cfg.max_batch, batch * 2)
            elif served and rpc_rate < cfg.target_rpc_per_s / 4 \
                    and batch > cfg.min_batch:
                knobs["batch_hint"] = max(cfg.min_batch, batch // 2)
            inflight = int(obs.get("max_inflight")
                           or self._s["max_inflight"] or cfg.min_inflight)
            pressure = throttled if f_throttled is None \
                else max(throttled, int(f_throttled))
            if pressure > 0:
                self._s["calm_ticks"] = 0
                if inflight < cfg.max_inflight:
                    knobs["max_inflight"] = min(
                        cfg.max_inflight, inflight * 2)
            else:
                self._s["calm_ticks"] = int(self._s["calm_ticks"]) + 1
                if self._s["calm_ticks"] >= cfg.calm_ticks_to_narrow \
                        and inflight > cfg.min_inflight \
                        and self._s["max_inflight"] is not None:
                    knobs["max_inflight"] = max(
                        cfg.min_inflight, inflight // 2)
                    self._s["calm_ticks"] = 0
            if knobs:
                self._s["batch_hint"] = knobs.get(
                    "batch_hint", self._s["batch_hint"])
                self._s["max_inflight"] = knobs.get(
                    "max_inflight", self._s["max_inflight"])
                reason = f"rpc_rate={rpc_rate:.1f}/s " \
                         f"throttled={throttled}/window"
                if f_rate is not None:
                    reason += f" forecast={f_rate:.1f}/s"
                out.append(self._emit("tune", args=knobs, reason=reason))

        # ---- shed arm -------------------------------------------------
        scale = float(self._s["scale"])
        shed_pressure = throttled if f_throttled is None \
            else max(throttled, int(f_throttled))
        if shed_pressure >= cfg.shed_threshold:
            new_scale = min(cfg.max_shed_scale, scale * 2.0)
        elif throttled == 0 and (f_throttled is None
                                 or int(f_throttled) <= 0) \
                and scale > 1.0:
            new_scale = max(1.0, scale / 2.0)
        else:
            new_scale = scale
        if new_scale != scale:
            self._s["scale"] = new_scale
            reason = f"throttled={throttled} (threshold " \
                     f"{cfg.shed_threshold}); retry_ms x{new_scale:g}"
            if f_throttled is not None and int(f_throttled) > throttled:
                reason += f" forecast={int(f_throttled)}"
            out.append(self._emit(
                "shed", args={"scale": new_scale}, reason=reason))

        # ---- backend arm ----------------------------------------------
        cand = obs.get("backend_candidate")
        cur = self._s["backend"] or obs.get("backend_current")
        gain = float(obs.get("backend_gain_pct", 100.0))
        if cfg.backend_pick and cand is not None and cand != cur \
                and gain >= cfg.backend_min_gain_pct:
            self._s["backend"] = str(cand)
            out.append(self._emit(
                "pick_backend", args={"backend": str(cand)},
                reason=f"regen cost model prefers {cand} over {cur}"))

        # ---- shard-map arm --------------------------------------------
        structural = False
        last_t = self._s["last_struct_t"]
        cooled = last_t is None or now - float(last_t) \
            >= cfg.struct_cooldown_s
        if len(live) >= 2 and cooled:
            mean = sum(d.get("served", 0) for d in live.values()) \
                / len(live)
            if mean > 0:
                d = self._struct_decision(
                    live, mean, cfg,
                    f_served if cfg.predictive else None)
                if d is not None:
                    structural = True
                    self._s["last_struct_t"] = now
                    out.append(d)

        # ---- drill arm ------------------------------------------------
        if cfg.drill_interval_s is not None and not structural:
            lag = obs.get("repl_lag_p95_ms")
            last = self._s["last_drill_t"]
            due = last is None or now - float(last) >= cfg.drill_interval_s
            if due and lag is not None and lag <= cfg.drill_max_lag_ms:
                self._s["last_drill_t"] = now
                out.append(self._emit(
                    "drill",
                    reason=f"repl_lag p95 {lag:.1f}ms <= "
                           f"{cfg.drill_max_lag_ms:g}ms; promoting "
                           "standby to measure failover"))

        # ---- prior learning -------------------------------------------
        # after prior_confirm_ticks knob-quiet serving ticks, the
        # current knobs become this workload's prior; the next WAL
        # record's pstate carries it, so a restart starts warm
        if wl is not None:
            tuned = any(d.kind == "tune" for d in out)
            if tuned or served == 0 or self._s["batch_hint"] is None:
                self._s["stable_ticks"] = 0
            else:
                self._s["stable_ticks"] = int(self._s["stable_ticks"]) + 1
                if self._s["stable_ticks"] >= cfg.prior_confirm_ticks:
                    pr = {"batch_hint": int(self._s["batch_hint"])}
                    if self._s["max_inflight"] is not None:
                        pr["max_inflight"] = int(self._s["max_inflight"])
                    priors = dict(self._s.get("priors") or {})
                    priors[str(wl)] = pr
                    self._s["priors"] = priors
        return out

    # ------------------------------------------------------------ helpers
    def _emit(self, kind: str, *, target=None, args=None,
              reason: str = "") -> Decision:
        self._s["seq"] = int(self._s["seq"]) + 1
        return Decision(seq=int(self._s["seq"]), kind=kind,
                        target=target, args=dict(args or {}),
                        reason=reason)

    def _struct_decision(self, live: dict, mean: float,
                         cfg: PolicyConfig,
                         fserved: Optional[dict] = None
                         ) -> Optional[Decision]:
        """One structural move, by fixed priority: split the hottest
        qualifying shard, else merge the coldest rank-adjacent pair,
        else migrate across the steepest adjacent hot/cold boundary.
        Ties break on the lowest shard id — determinism, not fairness.
        In predictive mode ``fserved`` carries per-shard forecast
        volumes: a shard whose FORECAST crosses the hot threshold
        splits before its p99 ever degrades — the forecast is the
        early-warning signal replacing the lagging latency gate."""
        fs = fserved or {}

        def eff(s):
            return max(live[s].get("served", 0), fs.get(s, 0.0))

        order = sorted(live)  # by shard id: deterministic tie-break
        hot = [s for s in order
               if eff(s) > cfg.hot_factor * mean
               and live[s].get("ranks", 0) >= 2 * cfg.min_shard_ranks
               and (float(live[s].get("p99_ms", 0.0)) >= cfg.split_p99_ms
                    or fs.get(s, 0.0) > cfg.hot_factor * mean)]
        if hot:
            sid = max(hot, key=lambda s: (eff(s), -s))
            reason = f"shard {sid} served {live[sid]['served']} " \
                     f"(> {cfg.hot_factor:g}x mean {mean:.0f}) with " \
                     f"p99 {live[sid].get('p99_ms', 0.0):.1f}ms"
            if fs.get(sid, 0.0) > live[sid].get("served", 0):
                reason += f"; forecast {fs[sid]:.0f}"
            return self._emit("split", target=int(sid), reason=reason)
        cold = {s for s in order
                if live[s].get("served", 0) < cfg.cold_factor * mean}
        for a, b in self._adjacent_pairs(live, order):
            if a in cold and b in cold:
                # fold the higher slice into the lower: one survivor
                into, frm = (a, b) if live[a]["lo"] < live[b]["lo"] \
                    else (b, a)
                return self._emit(
                    "merge", args={"into": int(into), "frm": int(frm)},
                    reason=f"shards {a} and {b} both under "
                           f"{cfg.cold_factor:g}x mean {mean:.0f}")
        for a, b in self._adjacent_pairs(live, order):
            sa, sb = eff(a), eff(b)
            hi_s, lo_s = (a, b) if sa >= sb else (b, a)
            if eff(hi_s) > cfg.hot_factor * mean \
                    and live[lo_s].get("served", 0) < mean \
                    and live[hi_s].get("ranks", 0) \
                    > 2 * cfg.min_shard_ranks:
                count = max(1, int(live[hi_s]["ranks"]) // 4)
                return self._emit(
                    "migrate",
                    args={"frm": int(hi_s), "to": int(lo_s),
                          "count": count},
                    reason=f"shard {hi_s} at {live[hi_s]['served']} vs "
                           f"{lo_s} at {live[lo_s]['served']}; moving "
                           f"{count} boundary rank(s)")
        return None

    @staticmethod
    def _adjacent_pairs(live: dict, order) -> list:
        """Rank-adjacent (lo-sorted) shard id pairs, deterministic."""
        by_lo = sorted(order, key=lambda s: int(live[s].get("lo", 0)))
        return [(by_lo[i], by_lo[i + 1]) for i in range(len(by_lo) - 1)
                if int(live[by_lo[i]].get("hi", -1))
                == int(live[by_lo[i + 1]].get("lo", -2))]


def _forecast(pts, horizon_s: float) -> float:
    """Least-squares slope extrapolation: the fitted trend evaluated
    ``horizon_s`` seconds past the newest point, clamped at zero.
    Closed-form over a handful of points — deterministic, allocation
    light, and exactly replayable (no randomness, no wall clock)."""
    n = len(pts)
    t0 = float(pts[0][0])
    xs = [float(t) - t0 for t, _ in pts]
    ys = [float(v) for _, v in pts]
    mx, my = sum(xs) / n, sum(ys) / n
    den = sum((x - mx) ** 2 for x in xs)
    slope = 0.0 if den <= 0.0 else \
        sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / den
    return max(0.0, ys[-1] + slope * float(horizon_s))
