"""The port's counterpart of the JAX package's ``tests/test_fleetsim.py``.

Every case runs on ``partiallyshuffledistributedsampler_tpu_torch`` with its
specs on ``backend="cpu"`` (no card), under the port's lock-order
sanitizer; the cross-package checks at the end hold the port against the
JAX package.  The JAX file's text follows.

fleetsim/: the deterministic fleet simulator + predictive autopilot.

The acceptance laws (docs/SIMULATOR.md):

* **determinism** — same scenario + same seed → the serialized trace
  AND the WAL-shaped decision log are byte-identical across runs;
* **replayability** — the recorded observation stream fed to a FRESH
  policy reproduces the recorded decision stream exactly;
* **sim/real parity** — the simulator drives the REAL policy /
  backpressure / shard-map code, so replaying a simulated trace's
  snapshots through a live two-shard plane produces the identical
  decision stream and identical on-disk ``autopilot`` WAL records;
* **predictive beats reactive** — on the same replayed workload the
  forecast-driven tune arm reaches the knob fixpoint in measurably
  fewer ticks than the reactive doubling ladder;
* **unattended resolution** — a 5 000-rank simulated hotspot resolves
  through split/migrate with no operator action;
* **warm restarts** — priors learned from a run's WAL records make a
  restarted deployment reproduce the converged knobs in one decision.

Plus chaos coverage for the two simulator fault sites (``sim.event``,
``sim.inject``) and the seeded latency/calibration plumbing.
"""

from __future__ import annotations

import dataclasses
import json
import signal

import numpy as np
import pytest

from partiallyshuffledistributedsampler_tpu_torch import faults as F
from partiallyshuffledistributedsampler_tpu_torch import fleetsim as fs
from partiallyshuffledistributedsampler_tpu_torch.autopilot import (
    Autopilot,
    AutopilotPolicy,
    PolicyConfig,
    learn_priors,
    warm_state,
)
from partiallyshuffledistributedsampler_tpu_torch.durability import (
    read_autopilot_records,
)
from partiallyshuffledistributedsampler_tpu_torch.fleetsim import (
    Calibration,
    DecisionTrace,
    EventLoop,
    LatencyModel,
    RegenCostModel,
    SimClock,
    decision_to_dict,
)
from partiallyshuffledistributedsampler_tpu_torch.fleetsim import (
    FleetSim as PortFleetSim,
)
from partiallyshuffledistributedsampler_tpu_torch.fleetsim.latency import (
    CHANNELS,
    RECORD_KIND,
)
from partiallyshuffledistributedsampler_tpu_torch.service import PartialShuffleSpec
from partiallyshuffledistributedsampler_tpu_torch.sharding import ShardPlane
from partiallyshuffledistributedsampler_tpu_torch.utils.metrics import (
    MetricsRegistry,
)

from partiallyshuffledistributedsampler_tpu_torch.analysis import lockorder
from partiallyshuffledistributedsampler_tpu import fleetsim as jfs
from partiallyshuffledistributedsampler_tpu.autopilot import (
    PolicyConfig as JPolicyConfig,
)
from partiallyshuffledistributedsampler_tpu.fleetsim import latency as JL

#: every port spec of this file regenerates on the host
BACKEND = "cpu"


#: each case's own wall-clock limit (pytest-timeout is not installed):
#: a hung socket fails its case, not the whole run
CASE_TIMEOUT_S = 90


@pytest.fixture(autouse=True)
def _case_deadline():
    def expired(signum, frame):
        raise TimeoutError(f"the case ran past {CASE_TIMEOUT_S} s")

    prev = signal.signal(signal.SIGALRM, expired)
    signal.alarm(CASE_TIMEOUT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, prev)


@pytest.fixture(autouse=True)
def _port_sanitizer():
    """The port's lock-order graph over every lock a case creates: a
    recorded cycle, or a non-daemon thread left running, fails it."""
    prior = lockorder.is_enabled()
    lockorder.reset()
    lockorder.enable()
    baseline = lockorder.thread_snapshot()
    yield
    found = lockorder.violations()
    lockorder.reset()
    if not prior:
        lockorder.disable()
    assert not found, lockorder.render_violations(found)
    leaked = lockorder.leaked_threads(baseline)
    assert not leaked, lockorder.thread_stacks(leaked)


pytestmark = pytest.mark.fleetsim


# ------------------------------------------------ the suite's scenarios
# The JAX suite tuned its scenarios (capacities, thresholds, tick
# counts) to its package's default calibration.  The port's defaults are
# the card's own, so the port runs the same scenarios with the JAX
# package's defaults handed in explicitly: scenario inputs, read from
# that package at run time, and both packages then simulate one world.
def scenario_calibration(**channels):
    base = {c: getattr(JL.Calibration(), c) for c in CHANNELS}
    base.update(channels)
    return Calibration(**base)


def scenario_cost(**kw):
    ref = JL.RegenCostModel(**kw)
    return RegenCostModel(**{f.name: getattr(ref, f.name)
                             for f in dataclasses.fields(ref)})


def FleetSim(**kw):
    """The port's ``FleetSim`` over the suite's scenario calibration
    (an explicit ``latency`` or ``regen_cost`` wins)."""
    kw.setdefault("latency", LatencyModel(
        seed=kw.get("seed", 0), calibration=scenario_calibration()))
    kw.setdefault("regen_cost", scenario_cost())
    return PortFleetSim(**kw)


# ---------------------------------------------------- clock + event loop
def test_sim_clock_is_monotonic_and_injectable():
    clk = SimClock()
    assert clk() == 0.0
    assert clk.advance(1.5) == 1.5
    assert clk.advance_to(4.0) == 4.0
    with pytest.raises(ValueError):
        clk.advance(-0.1)
    with pytest.raises(ValueError):
        clk.advance_to(3.9)
    # the policy accepts it wherever a monotonic callable is expected
    AutopilotPolicy(PolicyConfig(), clock=clk).decide(
        {"now": clk(), "window_s": 1.0, "served": 0, "throttled": 0})


def test_event_loop_dispatch_order_and_horizon():
    """Same-instant events dispatch in admission order (the seq
    tie-break), callbacks can self-reschedule, and ``run_until`` lands
    the clock exactly on the horizon — never past it."""
    clk = SimClock()
    loop = EventLoop(clk)
    order = []
    loop.at(2.0, lambda: order.append("b"))
    loop.at(1.0, lambda: order.append("a1"))
    loop.at(1.0, lambda: order.append("a2"))   # same instant, admitted later
    with pytest.raises(ValueError):
        loop.at(-1.0, lambda: None)            # scheduling into the past
    n = loop.run_until(1.0)
    assert n == 2 and order == ["a1", "a2"] and clk() == 1.0
    loop.run_until(10.0)
    assert order == ["a1", "a2", "b"] and clk() == 10.0

    ticks = []

    def tick():
        ticks.append(clk())
        if len(ticks) < 3:
            loop.after(1.0, tick)

    loop.after(1.0, tick)
    loop.run_until(20.0)
    assert ticks == [11.0, 12.0, 13.0] and clk() == 20.0


# ------------------------------------------------------- latency models
def test_latency_streams_are_seeded_and_channel_independent():
    """Same seed → same per-channel stream; and drawing another channel
    never perturbs a channel's own timeline (independent RNGs)."""
    a, b = LatencyModel(seed=7), LatencyModel(seed=7)
    xs = [a.sample("rpc") for _ in range(8)]
    ys = []
    for _ in range(8):
        b.sample("wal_fsync")          # interleaved draws elsewhere
        ys.append(b.sample("rpc"))
    assert xs == ys
    assert all(x > 0.0 for x in xs)
    assert LatencyModel(seed=8).sample("rpc") != xs[0]
    assert a.p99("regen") > a.p50("regen")
    with pytest.raises(KeyError):
        a.sample("nope")


def test_calibration_from_bench_reads_only_card_records(tmp_path):
    """``from_bench`` reads the records the card wrote (phase 21 of
    ``chip_smoke.py``): each channel takes the median record's
    ``(p50, sigma)``.  Another device's record, another file form, or
    the JAX package's ``BENCH_r0*.json`` tails are never read; a root
    with no card record keeps every default."""
    default = Calibration()
    assert Calibration.from_bench(".") == default      # BENCH_r0*.json
    assert Calibration.from_bench(tmp_path) == default
    (tmp_path / "BENCH_r01.json").write_text(json.dumps(
        {"tail": '"extra_eager_dispatch_ms": 9.5'}))

    def record(name, platform, **channels):
        (tmp_path / name).write_text(json.dumps({
            "kind": RECORD_KIND, "source": "chip_smoke.py --sharding",
            "device": {"platform": platform, "name": "card",
                       "power_limit": "700.00 W"},
            "channels": channels}))

    record("fleetsim_calibration_a.json", "gpu", rpc=[0.5, 0.2],
           regen=[4.0, 0.3])
    record("fleetsim_calibration_b.json", "gpu", rpc=[0.7, 0.1])
    record("fleetsim_calibration_c.json", "gpu", rpc=[0.6, 0.4])
    record("fleetsim_calibration_d.json", "cpu", rpc=[99.0, 0.1],
           barrier=[99.0, 0.1])
    (tmp_path / "fleetsim_calibration_e.json").write_text("not json")
    cal = Calibration.from_bench(tmp_path)
    assert cal.rpc == (0.6, 0.4)              # the median record's pair
    assert cal.regen == (4.0, 0.3)
    assert cal.wal_fsync == default.wal_fsync
    assert cal.barrier == default.barrier     # the other device's skipped


def test_regen_cost_model_from_bench_takes_the_median(tmp_path):
    """``RegenCostModel.from_bench`` reads the records
    ``Calibration.from_bench`` reads: each cost field takes the median of
    the card records' values; another device's record is skipped, and a
    field no record carries keeps its default."""
    default = RegenCostModel()
    assert RegenCostModel.from_bench(tmp_path) == default

    def record(name, platform, **cost):
        (tmp_path / name).write_text(json.dumps({
            "kind": RECORD_KIND, "source": "chip_smoke.py --sharding",
            "device": {"platform": platform, "name": "card",
                       "power_limit": "700.00 W"},
            "channels": {}, "regen_cost": cost}))

    record("fleetsim_calibration_a.json", "gpu", host_backend="native",
           host_fixed_ms=0.4, dev_fixed_ms=0.10)
    record("fleetsim_calibration_b.json", "gpu", host_backend="native",
           host_fixed_ms=0.9, dev_fixed_ms=0.07)
    record("fleetsim_calibration_c.json", "gpu", host_backend="native",
           host_fixed_ms=0.5, dev_fixed_ms=0.08, dev_rate_ms=2e-7)
    record("fleetsim_calibration_d.json", "cpu", host_fixed_ms=99.0,
           dev_fixed_ms=99.0)
    got = RegenCostModel.from_bench(tmp_path)
    assert (got.host_fixed_ms, got.dev_fixed_ms) == (0.5, 0.08)
    assert got.dev_rate_ms == 2e-7 and got.host_backend == "native"
    assert got.host_rate_ms == default.host_rate_ms
    assert got.weighted_rate_mult == default.weighted_rate_mult


def test_regen_cost_model_crossover_and_gain():
    """On the JAX suite's scenario lines the host line wins small
    per-rank epochs and the device line huge ones; on the card's own
    lines (the port's defaults) the device's launch-and-readback floor is
    below the host's fixed cost, so the card wins from one sample up.
    ``pick`` reports the live probe's info shape plus the gain margin the
    backend arm thresholds on."""
    m = scenario_cost()
    small, _, info_s = m.pick(1 << 10)
    big, gain_b, info_b = m.pick(10 << 20)
    assert small == m.host_backend and big == "cuda"
    assert gain_b > 50.0
    for info in (info_s, info_b):
        assert info["picked"] in (m.host_backend, "cuda")
        assert info["est_host_ms"] > 0.0 and info["est_device_ms"] > 0.0
    card = RegenCostModel()
    assert card.dev_fixed_ms < card.host_fixed_ms
    for n in (1, 1 << 10, 1 << 20, 3_906_250):
        got, gain, info = card.pick(n)
        assert got == info["picked"] == "cuda" and gain > 0.0
    assert card.pick(3_906_250)[1] > 99.0


# ------------------------------------------- determinism + replay laws
def _tune_sim(seed: int = 3, predictive: bool = False,
              ticks: int = 14) -> FleetSim:
    sim = FleetSim(world=8, n_shards=2, n=8 << 20,
                   workload=fs.workload.uniform(100_000.0, key="tune-wl"),
                   seed=seed, config=PolicyConfig(predictive=predictive))
    sim.run(ticks)
    return sim


def test_same_scenario_and_seed_is_byte_identical():
    """The determinism law: two fresh runs of the same scenario with
    the same seed serialize to the same bytes — the full trace AND the
    WAL-shaped decision log the acceptance criterion names."""
    a, b = _tune_sim(seed=3), _tune_sim(seed=3)
    assert a.trace.to_jsonl() == b.trace.to_jsonl()
    assert a.trace.decision_log() == b.trace.decision_log()
    assert len(a.trace.decision_log()) > 0
    # a different seed perturbs the sampled latencies, not the laws
    c = _tune_sim(seed=4)
    assert c.trace.to_jsonl() != a.trace.to_jsonl()


def test_trace_replays_through_a_fresh_policy():
    """The replay law: the recorded observations fed to a FRESH policy
    reproduce the recorded decision stream — through a JSONL round
    trip, exactly as an operator would replay a trace file."""
    sim = _tune_sim(seed=3)
    trace = DecisionTrace.from_jsonl(sim.trace.to_jsonl())
    assert len(trace) == len(sim.trace)
    trace.verify_replay(
        lambda: AutopilotPolicy(PolicyConfig(), clock=lambda: 0.0,
                                seed=sim.seed))


def test_wal_records_ride_the_live_record_shape():
    sim = _tune_sim(seed=3)
    recs = sim.trace.wal_records()
    assert recs, "scenario produced no decisions"
    for r in recs:
        assert r["op"] == "autopilot"
        assert set(r) >= {"seq", "kind", "target", "args", "reason",
                          "knobs", "workload", "pstate"}
        assert r["workload"] == "tune-wl"
    assert learn_priors(recs).get("tune-wl", {}).get("batch_hint") \
        == sim.batch


# --------------------------------------------- acceptance: predictive
def _ticks_to_fixpoint(sim: FleetSim) -> int:
    """1-based tick at which the transport batch reached its final
    value and never moved again."""
    hist = []
    for e in sim.trace.entries:
        b = e["obs"]["batch"]
        for d in e["decisions"]:
            if d["kind"] == "tune" and d["args"].get("batch_hint"):
                b = d["args"]["batch_hint"]
        hist.append(b)
    final = hist[-1]
    assert sim.batch == final
    return 1 + next(i for i in range(len(hist))
                    if all(x == final for x in hist[i:]))


def test_predictive_reaches_fixpoint_in_fewer_ticks():
    """The predictive acceptance law: on the same replayed workload the
    forecast-driven tune arm jumps every ladder rung in one decision,
    reaching the knob fixpoint in measurably fewer ticks than the
    reactive doubling ladder — and at the SAME fixpoint."""
    reactive = _tune_sim(seed=3, predictive=False)
    predictive = _tune_sim(seed=3, predictive=True)
    assert predictive.batch == reactive.batch == 16384
    tr, tp = _ticks_to_fixpoint(reactive), _ticks_to_fixpoint(predictive)
    assert tp < tr, f"predictive {tp} ticks vs reactive {tr}"
    assert tr - tp >= 2, f"gain not measurable: {tr} vs {tp}"
    assert predictive.registry.get("sim_tunes") \
        < reactive.registry.get("sim_tunes")


def test_predictive_sheds_before_forecast_saturation():
    """A fleet-wide surge with a rising slope: the predictive shed arm
    acts on the forecast throttle pressure no later than the reactive
    one waits for the observed refusals."""

    def run(predictive):
        cfg = PolicyConfig(min_batch=1024, max_batch=1024,
                           min_inflight=2, max_inflight=2,
                           predictive=predictive)
        sim = FleetSim(
            world=64, n_shards=2, n=64 << 20,
            workload=fs.workload.hotspot(
                2500.0, hot_lo=0, hot_hi=64, factor=40.0, at_s=4.0,
                ramp_s=12.0, key="surge-wl"),
            seed=9, config=cfg,
            latency=LatencyModel(seed=9,
                                 calibration=scenario_calibration(rpc=(8.0, 0.05))))
        sim.run(16)
        for e in sim.trace.entries:
            if any(d["kind"] == "shed" for d in e["decisions"]):
                return e["tick"]
        return None

    t_reactive, t_predictive = run(False), run(True)
    assert t_reactive is not None and t_predictive is not None
    assert t_predictive <= t_reactive


# ------------------------------------- acceptance: unattended hotspot
def test_hotspot_5000_ranks_resolves_via_split_unattended():
    """The 5 000-rank acceptance scenario: one shard's rank band ramps
    to 10x demand against a deliberately tight capacity model; the
    policy splits (and rebalances) the hot shard with no operator
    action, and the fleet ends the run unthrottled with headroom."""
    cfg = PolicyConfig(min_batch=1024, max_batch=1024, min_inflight=2,
                       max_inflight=4, hot_factor=2.0, split_p99_ms=5.0,
                       struct_cooldown_s=3.0, target_rpc_per_s=1e9)
    sim = FleetSim(
        world=5000, n_shards=4, n=5000 << 20,
        workload=fs.workload.hotspot(10.0, hot_lo=0, hot_hi=1250,
                                     factor=10.0, at_s=5.0, ramp_s=5.0),
        seed=7, config=cfg,
        latency=LatencyModel(seed=7,
                             calibration=scenario_calibration(rpc=(40.0, 0.05))))
    sim.run(40)
    assert sim.registry.get("sim_splits") >= 1
    assert len(sim.live_shards()) > 4
    # resolved: the last window throttled nothing and utilization has
    # real headroom on every live shard
    assert sim.trace.entries[-1]["obs"]["throttled"] == 0
    assert sim.max_util() < 0.9
    # the structural moves were decided by the real policy and are in
    # the replayable log
    kinds = {d["kind"] for d in sim.trace.decisions()}
    assert "split" in kinds
    sim.trace.verify_replay(
        lambda: AutopilotPolicy(cfg, clock=lambda: 0.0, seed=sim.seed))


# ------------------------------------------ acceptance: warm restarts
def test_warm_started_priors_reproduce_converged_knobs():
    """Priors learned from a run's WAL records make a RESTARTED
    deployment jump to the converged knobs in one warm-start decision
    and stay there — no re-climb of the doubling ladder."""
    first = _tune_sim(seed=3)
    assert first.policy.state_dict()["priors"], "no prior confirmed"
    priors = learn_priors(first.trace.wal_records())
    assert priors["tune-wl"]["batch_hint"] == first.batch

    second = FleetSim(world=8, n_shards=2, n=8 << 20,
                      workload=fs.workload.uniform(100_000.0,
                                                   key="tune-wl"),
                      seed=3, config=PolicyConfig())
    second.policy.load_state_dict(warm_state(priors))
    second.run(1)
    d0 = second.trace.entries[0]["decisions"]
    assert len(d0) == 1 and d0[0]["kind"] == "tune"
    assert d0[0]["reason"].startswith("warm start from prior")
    assert second.batch == first.batch
    second.run(9)
    # converged immediately: the warm-start tune was the ONLY tune
    assert second.registry.get("sim_tunes") == 1
    assert second.batch == first.batch


# --------------------------------------- satellite: backend_pick arm
def test_backend_pick_agrees_between_sim_and_real_plane():
    """``backend_pick`` is on by default, and on identical workload
    shapes the simulated plane and a REAL two-shard plane (its own
    ``_observe``, the same injected cost probe) emit the identical
    ``pick_backend`` decision."""
    assert PolicyConfig().backend_pick is True
    rcm = RegenCostModel(host_backend="cpu")

    sim = FleetSim(world=4, n_shards=2, n=40 << 20,
                   workload=fs.workload.uniform(5000.0, key="backend-wl"),
                   seed=5, backend="cpu", regen_cost=rcm)
    sim.run(1)
    sim_d = sim.trace.entries[0]["decisions"]
    assert [d["kind"] for d in sim_d] == ["pick_backend"]
    assert sim_d[0]["args"] == {"backend": "cuda"}

    spec = PartialShuffleSpec.plain(40 << 20, window=4096, world=4, backend=BACKEND)
    clk = SimClock(100.0)
    with ShardPlane(spec, 2) as plane:
        ap = Autopilot(
            plane=plane, clock=clk,
            policy=AutopilotPolicy(PolicyConfig(), clock=clk, seed=5),
            backend_probe=lambda n: (rcm.pick(n)[0], rcm.pick(n)[2]))
        clk.advance(1.0)
        real_d = [decision_to_dict(d) for d in ap.tick()]
    assert real_d == sim_d


def test_backend_probe_gated_below_min_samples():
    """Tiny specs never pay (or log) a backend probe: the controller's
    size gate keeps the arm silent below BACKEND_PROBE_MIN_SAMPLES per
    rank, so toy deployments stay byte-identical to the reactive
    baseline."""
    spec = PartialShuffleSpec.plain(2048, window=128, world=2, backend=BACKEND)
    clk = SimClock(100.0)
    with ShardPlane(spec, 2) as plane:
        ap = Autopilot(plane=plane, clock=clk)
        clk.advance(1.0)
        obs = ap._observe()
    assert spec.n // spec.world < Autopilot.BACKEND_PROBE_MIN_SAMPLES
    assert "backend_candidate" not in obs


# ------------------------------ satellite: seeded sim/real parity law
@pytest.mark.parametrize("seed", [11, 23])
def test_sim_and_real_plane_decide_identically(seed, tmp_path):
    """The parity law, end to end: a simulated hotspot run's metric
    snapshots replayed through a REAL two-shard plane (real servers,
    real WAL on disk, real split/merge/migrate actuations) produce the
    IDENTICAL decision stream and the identical ``autopilot`` WAL
    records — field for field, including the policy state each record
    carries."""
    cfg = PolicyConfig(min_batch=256, max_batch=256, min_inflight=2,
                       max_inflight=4, hot_factor=1.5, split_p99_ms=0.2,
                       struct_cooldown_s=3.0, target_rpc_per_s=1e9)
    sim = FleetSim(
        world=8, n_shards=2, n=4096,
        workload=fs.workload.hotspot(1000.0, hot_lo=0, hot_hi=4,
                                     factor=10.0, at_s=3.0, ramp_s=4.0,
                                     key="parity-wl"),
        seed=seed, config=cfg, batch0=256, backend="cpu",
        latency=LatencyModel(seed=seed,
                             calibration=scenario_calibration(rpc=(40.0, 0.05))))
    sim.run(12)
    kinds = {d["kind"] for d in sim.trace.decisions()}
    assert "split" in kinds, f"scenario lost its structural move: {kinds}"

    # replay through a trace-file round trip: what an operator replays
    trace = DecisionTrace.from_jsonl(sim.trace.to_jsonl())
    obs_iter = iter([e["obs"] for e in trace.entries])
    rcm = sim.regen_cost
    spec = PartialShuffleSpec.plain(4096, window=256, world=8, backend=BACKEND)
    wal_dir = str(tmp_path / "plane-wal")
    with ShardPlane(spec, 2, wal_dir=wal_dir) as plane:
        ap = Autopilot(
            plane=plane, clock=lambda: 0.0,
            policy=AutopilotPolicy(cfg, clock=lambda: 0.0, seed=seed),
            observe=lambda: next(obs_iter, None),
            backend_probe=lambda n: (rcm.pick(n)[0], rcm.pick(n)[2]))
        real_stream = [[decision_to_dict(d) for d in ap.tick()]
                       for _ in range(len(trace))]
        # the observation stream is exhausted: further ticks are no-ops
        assert ap.tick() == []
        assert plane.map.n_shards > 2    # the split really happened

    sim_stream = [e["decisions"] for e in trace.entries]
    assert real_stream == sim_stream

    recs = read_autopilot_records(f"{wal_dir}/0")
    got = [{k: v for k, v in r.items() if k != "lsn"} for r in recs]
    assert got == trace.wal_records()


# ------------------------------------------------- chaos: fault sites
def test_chaos_sim_event_fault_drops_one_event_only():
    """An injected ``sim.event`` error drops exactly that dispatch —
    counted, never fatal — and every other queued event still fires
    (parity with the live controller surviving one bad tick)."""
    reg = MetricsRegistry()
    clk = SimClock()
    loop = EventLoop(clk, registry=reg)
    fired = []
    for i in range(5):
        loop.at(float(i + 1), lambda i=i: fired.append(i))
    with F.FaultPlan([F.FaultRule(site="sim.event", kind="error",
                                  nth=3)]) as plan:
        loop.run_until(10.0)
        assert plan.fired("sim.event") == 1
    assert fired == [0, 1, 3, 4]         # the third dispatch was eaten
    assert reg.get("sim_event_faults") == 1
    assert reg.get("sim_events") == 4
    assert clk() == 10.0


def test_chaos_sim_inject_fault_suppresses_the_scenario_injection():
    """An injected ``sim.inject`` error eats the scenario injection
    (the surge never lands, the run matches the unperturbed baseline)
    and is counted on the sim registry."""

    def run(faulted):
        sim = _build()
        if faulted:
            with F.FaultPlan([F.FaultRule(site="sim.inject",
                                          kind="error")]) as plan:
                sim.run(8)
                assert plan.fired("sim.inject") == 1
        else:
            sim.run(8)
        return sim

    def _build():
        sim = FleetSim(world=8, n_shards=2, n=8 << 20,
                       workload=fs.workload.uniform(100_000.0,
                                                    key="inj-wl"),
                       seed=3, config=PolicyConfig())
        sim.inject_surge(at_s=2.5, factor=4.0)
        return sim

    baseline = _tune_sim(seed=3, ticks=8)
    surged, eaten = run(False), run(True)
    assert surged.registry.get("sim_injected") == 1
    assert eaten.registry.get("sim_injected") == 0
    assert eaten.registry.get("sim_inject_faults") == 1
    # the eaten injection leaves the run identical to no injection at
    # all (workload key aside, the decision stream matches)
    assert [e["decisions"] for e in eaten.trace.entries] \
        == [e["decisions"] for e in baseline.trace.entries]
    assert surged.trace.decision_log() != baseline.trace.decision_log()


# ------------------------------------- acceptance: cell-kill DR drill
def test_cell_kill_5000_ranks_flips_directory_and_replays():
    """The federated DR drill at fleet scale (docs/FEDERATION.md): a
    5 000-rank fleet loses its entire home cell mid-epoch.  The DR cell
    promotes — the directory flips every tenant in ONE version bump,
    the fleet's next window rides a full failover freeze — and the
    decision/WAL trace stays byte-identical across runs and replays
    deterministically through a fresh policy."""
    def _build():
        sim = FleetSim(
            world=5000, n_shards=4, n=5000 << 20,
            workload=fs.workload.uniform(50_000.0, key="dr-wl"),
            seed=7, config=PolicyConfig(),
            cells=("east", "west"),
            latency=LatencyModel(seed=7,
                                 calibration=scenario_calibration()))
        sim.inject_cell_kill(at_s=10.0)
        return sim

    a = _build().run(25)
    b = _build().run(25)
    # determinism law: same scenario + seed → identical bytes, overlay
    # keys (cell / directory version+fingerprint) included
    assert a.trace.to_jsonl() == b.trace.to_jsonl()
    assert a.trace.decision_log() == b.trace.decision_log()

    assert a.registry.get("sim_cell_kills") == 1
    assert a.cell == "west"
    assert a.cell_directory.version == 2
    assert a.cell_directory.home("any-tenant") == "west"
    st = a.status()
    assert st["cell"] == "west" and st["directory_version"] == 2

    # the flip happens exactly once, never reverts, and bumps the
    # directory fingerprint with it
    cells = [e["cell"] for e in a.trace.entries]
    assert cells[0] == "east" and cells[-1] == "west"
    flips = [i for i in range(1, len(cells)) if cells[i] != cells[i - 1]]
    assert len(flips) == 1
    versions = [e["directory_version"] for e in a.trace.entries]
    assert sorted(set(versions)) == [1, 2]
    fps = {e["directory_version"]: e["directory_fingerprint"]
           for e in a.trace.entries}
    assert fps[1] != fps[2]
    # the kill's failover barrier froze the post-flip window: observed
    # demand on every live shard collapses for exactly that tick
    k = flips[0]
    pre, post = a.trace.entries[k - 1]["obs"], a.trace.entries[k]["obs"]
    assert post["served"] < pre["served"]

    # replay law: the recorded stream reproduces through a FRESH policy
    trace = DecisionTrace.from_jsonl(a.trace.to_jsonl())
    trace.verify_replay(
        lambda: AutopilotPolicy(PolicyConfig(), clock=lambda: 0.0,
                                seed=a.seed))


# ------------------------------------ the sampling suite's fleetsim cases
SIZES = (40, 30, 26)   #: three sources over a 96-id space
T = 96                 #: epoch draw budget
T_DEDUP = 48           #: dedup epochs draw half the id space


def build_sampling_spec(mode, world=1):
    from partiallyshuffledistributedsampler_tpu_torch.sampling import (
        SamplingSpec,
    )

    kw = dict(seed=7, window=8, world=world, backend=BACKEND)
    if mode == "weighted":
        return SamplingSpec.weighted(SIZES, (3, 1, 2), epoch_samples=T,
                                     **kw)
    if mode == "prioritized":
        return SamplingSpec.prioritized(SIZES, (1, 1, 1), epoch_samples=T,
                                        **kw)
    return SamplingSpec.deduped(SIZES, epoch_samples=T_DEDUP, **kw)


def test_fleetsim_prices_sampling_modes():
    """``tests/test_sampling.py``'s cost-model plumb on the port."""
    from partiallyshuffledistributedsampler_tpu_torch.autopilot.priors import (
        workload_key,
    )

    m = RegenCostModel()
    n = 50_000_000
    # dedup regen is host-bound: the device line must NOT look cheap
    assert m.estimate_ms("cuda", n, "dedup") == m.estimate_ms(
        "native", n, "dedup")
    assert m.pick(n, "dedup")[0] == m.host_backend
    assert m.pick(n)[0] == "cuda", "uniform crossover regressed"
    assert m.pick(n, "weighted")[2]["sampling_mode"] == "weighted"
    # priors: sampling workloads get their own warm-start keys, and
    # uniform keys keep their historical form
    uni = PartialShuffleSpec("plain", n=96, window=8, world=2,
                             backend=BACKEND)
    assert workload_key(uni) == "n96:w2"
    assert workload_key(build_sampling_spec("dedup", world=2)) \
        == "n96:w2:sdedup"
    assert (workload_key(build_sampling_spec("weighted", world=2))
            == "n96:w2:sweighted")


def test_fleetsim_cost_model_and_priors_know_sampling_modes():
    """``tests/test_sampling.py``'s fleetsim integration on the port: a
    dedup fold pays host-side work on every backend, and a sampling
    workload never warm-starts a uniform deployment of the same shape."""
    from partiallyshuffledistributedsampler_tpu_torch.autopilot.priors import (
        workload_key,
    )
    from partiallyshuffledistributedsampler_tpu_torch.fleetsim.workload import (
        uniform,
    )

    m = RegenCostModel()
    n = 1 << 20
    base_dev = m.estimate_ms("cuda", n)
    assert m.estimate_ms("cuda", n, sampling_mode="dedup") > base_dev
    assert (m.estimate_ms("cuda", n, sampling_mode="dedup")
            == m.estimate_ms("native", n, sampling_mode="dedup"))
    assert (m.estimate_ms("cuda", n, sampling_mode="weighted")
            == pytest.approx(m.dev_fixed_ms
                             + m.dev_rate_ms * m.weighted_rate_mult * n))
    cand, _, info = m.pick(n, sampling_mode="dedup")
    assert info["sampling_mode"] == "dedup"

    uni = build_sampling_spec("weighted", world=2)
    plain_key = f"n{uni.n}:w2"
    assert workload_key(uni) == f"n{uni.n}:w2:sweighted"
    assert workload_key(build_sampling_spec("dedup", world=2)).endswith(
        ":sdedup")

    class _PlainShape:
        n, world = uni.n, 2

    assert workload_key(_PlainShape()) == plain_key

    sim = PortFleetSim(world=8, n_shards=2, n=1 << 16,
                       workload=uniform(200.0), seed=3,
                       sampling_mode="dedup")
    sim.run(ticks=2)
    assert sim.sampling_mode == "dedup"


# ------------------------------------------------- across the two packages
def _jax_pair(cal, rcm):
    """The JAX package's ``Calibration``/``RegenCostModel`` with the
    port's fields."""
    return (jfs.Calibration(**{c: getattr(cal, c) for c in CHANNELS}),
            jfs.RegenCostModel(**{f.name: getattr(rcm, f.name)
                                  for f in dataclasses.fields(rcm)}))


def _as_port(text):
    """A JAX trace in the port's words: its device tier is "cuda"."""
    return text.replace("xla", "cuda")


SCENARIOS = {
    "tune": lambda m: dict(
        world=8, n_shards=2, n=8 << 20, seed=3,
        workload=m.workload.uniform(100_000.0, key="tune-wl")),
    "hotspot": lambda m: dict(
        world=500, n_shards=4, n=500 << 20, seed=7,
        workload=m.workload.hotspot(10.0, hot_lo=0, hot_hi=125,
                                    factor=10.0, at_s=5.0, ramp_s=5.0)),
    "cells": lambda m: dict(
        world=64, n_shards=2, n=64 << 20, seed=5, cells=("east", "west"),
        workload=m.workload.uniform(50_000.0, key="dr-wl")),
    "dedup": lambda m: dict(
        world=8, n_shards=2, n=1 << 16, seed=3, sampling_mode="dedup",
        workload=m.workload.uniform(200.0)),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("calibration", ["port", "explicit"])
def test_decision_trace_equal_across_packages(scenario, calibration):
    """One seed, one explicit ``Calibration`` and one ``RegenCostModel``
    give the same ``DecisionTrace`` and WAL records in both packages,
    byte for byte with "cuda" for "xla" — over the port's card defaults
    and over a calibration where the device line wins at once."""
    if calibration == "port":
        cal, rcm = Calibration(), RegenCostModel()
    else:
        cal = Calibration(rpc=(40.0, 0.05), regen=(7.0, 0.3),
                          wal_fsync=(1.0, 0.2), barrier=(30.0, 0.1))
        rcm = RegenCostModel(host_fixed_ms=0.1, host_rate_ms=5e-6,
                             dev_fixed_ms=0.5, dev_rate_ms=1e-8)
    jcal, jrcm = _jax_pair(cal, rcm)
    cfg = dict(min_batch=256, max_batch=4096, hot_factor=2.0,
               split_p99_ms=1.0, struct_cooldown_s=3.0)

    def run(m, policy_config, c, r):
        kw = SCENARIOS[scenario](m)
        sim = m.FleetSim(config=policy_config(**cfg),
                         latency=m.LatencyModel(seed=kw["seed"],
                                                calibration=c),
                         regen_cost=r, **kw)
        if scenario == "cells":
            sim.inject_cell_kill(at_s=6.0)
        return sim.run(14)

    port = run(fs, PolicyConfig, cal, rcm)
    ref = run(jfs, JPolicyConfig, jcal, jrcm)
    assert len(port.trace) == len(ref.trace) == 14
    assert port.trace.to_jsonl() == _as_port(ref.trace.to_jsonl())
    assert port.trace.decision_log() == _as_port(ref.trace.decision_log())
    assert json.dumps(port.trace.wal_records(), sort_keys=True) == \
        _as_port(json.dumps(ref.trace.wal_records(), sort_keys=True))
    assert port.status() == json.loads(_as_port(json.dumps(ref.status())))


def test_latency_streams_and_cost_lines_equal_across_packages():
    """The seeded channel streams and the cost lines are the JAX
    package's functions: equal samples, p99s and picks (device tier
    renamed) for one calibration."""
    cal, rcm = Calibration(), RegenCostModel()
    jcal, jrcm = _jax_pair(cal, rcm)
    a = LatencyModel(seed=11, calibration=cal)
    b = jfs.LatencyModel(seed=11, calibration=jcal)
    for chan in CHANNELS:
        assert [a.sample(chan) for _ in range(16)] == \
            [b.sample(chan) for _ in range(16)]
        assert a.p99(chan) == b.p99(chan)
    for n in (1, 1 << 10, 1 << 16, 1 << 20, 3_906_250, 50_000_000):
        for mode in (None, "weighted", "dedup"):
            got, want = rcm.pick(n, mode), jrcm.pick(n, mode)
            assert got[1] == want[1]
            assert json.dumps(got[2], sort_keys=True) == \
                _as_port(json.dumps(want[2], sort_keys=True))
            assert rcm.estimate_ms("cuda", n, mode) == \
                jrcm.estimate_ms("xla", n, mode)
    assert np.isfinite(RegenCostModel().pick(3_906_250)[1])
