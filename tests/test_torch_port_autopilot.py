"""The port's counterpart of the JAX package's ``tests/test_autopilot.py``.

Every case runs on ``partiallyshuffledistributedsampler_tpu_torch`` with its
specs on ``backend="cpu"`` (no card), under the port's lock-order
sanitizer; the cross-package checks at the end hold the port against the
JAX package.  The JAX file's text follows.

autopilot/: closed-loop self-tuning and the elastic shard map.

The acceptance laws (docs/AUTOPILOT.md): the policy is a *deterministic*
function of its state and the windowed observation — same trajectory on
every replay, including on a promoted standby that inherited the WAL's
``autopilot`` records; knob tunes converge the transport batch toward
the target RPC rate on the BASELINE workload shapes; structural moves
(split / merge / migrate) never change served bits — a stream folded
across any shard-map transform is bit-identical to a static single
``IndexServer``; and a disabled autopilot costs zero protocol bytes.

Covered here: policy convergence on two BASELINE workload shapes under a
fake clock; decision determinism + ``state_dict`` replay; the shed arm
scaling the typed-backpressure table; the ``BackpressurePolicy`` table
itself; metric ``snapshot()``/``delta()``; live knob tuning end-to-end
(WELCOME/heartbeat → client adoption at an epoch boundary); the
split-under-hotspot drill with no operator action; merge + migrate
bit-identity vs a single server; controller-state inheritance across a
primary kill; and chaos coverage for every new fault site.
"""

from __future__ import annotations

import json
import signal

import numpy as np
import pytest

from partiallyshuffledistributedsampler_tpu_torch import faults as F
from partiallyshuffledistributedsampler_tpu_torch.autopilot import (
    Autopilot,
    AutopilotPolicy,
    PolicyConfig,
)
from partiallyshuffledistributedsampler_tpu_torch.service import (
    IndexServer,
    PartialShuffleSpec,
    ServiceIndexClient,
)
from partiallyshuffledistributedsampler_tpu_torch.service.backpressure import (
    DEFAULT_RETRY_MS,
    MAX_RETRY_MS,
    BackpressurePolicy,
)
from partiallyshuffledistributedsampler_tpu_torch.sharding import ShardPlane
from partiallyshuffledistributedsampler_tpu_torch.utils.metrics import (
    MetricsRegistry,
    histogram_delta,
    registry_delta,
)

from test_torch_port_failover import replicated_pair, wait_for, wait_synced

from partiallyshuffledistributedsampler_tpu_torch.analysis import lockorder
from partiallyshuffledistributedsampler_tpu_torch.durability import (
    read_autopilot_records,
)
from partiallyshuffledistributedsampler_tpu_torch.fleetsim import (
    decision_to_dict,
)
from partiallyshuffledistributedsampler_tpu import autopilot as JA
from partiallyshuffledistributedsampler_tpu import durability as JD
from partiallyshuffledistributedsampler_tpu import fleetsim as jfs
from partiallyshuffledistributedsampler_tpu import service as JS
from partiallyshuffledistributedsampler_tpu import sharding as JSH

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


pytestmark = pytest.mark.autopilot


class FakeClock:
    """Deterministic monotonic seconds for policy/controller tests."""

    def __init__(self, t0: float = 100.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += float(dt)
        return self.t


# --------------------------------------------------------------- policy
#: two BASELINE.json workload shapes (configs[0] and [1]): total sample
#: throughput the serving plane sustains, and the batch clients start at
BASELINE_WORKLOADS = [
    # "CIFAR-10 torchvision DDP, window=512, 2 ranks (CPU reference)"
    pytest.param(50_000.0, 512, id="cifar10-w512-2ranks"),
    # "ImageNet-1k ResNet-50 DDP, window=8192, 8 ranks"
    pytest.param(160_000.0, 1024, id="imagenet-w8192-8chips"),
]


def _run_tune_loop(policy, clock, throughput, batch, ticks=32):
    """Simulate the observe→decide→adopt loop: each tick serves one
    second of the workload at the currently adopted batch."""
    trajectory = []
    for _ in range(ticks):
        clock.advance(1.0)
        served = max(1, int(throughput / batch))
        obs = {"now": clock(), "window_s": 1.0, "served": served,
               "throttled": 0, "batch": batch}
        for d in policy.decide(obs):
            assert d.kind == "tune"
            if "batch_hint" in d.args:
                batch = int(d.args["batch_hint"])
        trajectory.append(batch)
    return trajectory


@pytest.mark.parametrize("throughput,batch0", BASELINE_WORKLOADS)
def test_policy_batch_converges_on_baseline_workloads(throughput, batch0):
    """On both BASELINE shapes the tune arm converges the transport
    batch to a fixpoint whose RPC rate sits inside the target band
    (target/4, target], and then goes quiet — no oscillation."""
    cfg = PolicyConfig(min_batch=256)
    clock = FakeClock()
    policy = AutopilotPolicy(cfg, clock=clock)
    traj = _run_tune_loop(policy, clock, throughput, batch0)
    settled = traj[-8:]
    assert len(set(settled)) == 1, f"batch oscillates: {traj}"
    rate = throughput / settled[-1]
    assert rate <= cfg.target_rpc_per_s
    assert rate > cfg.target_rpc_per_s / 4 or settled[-1] == cfg.max_batch


def test_policy_decisions_deterministic_and_replayable():
    """Same config + same observation sequence → the identical decision
    list; and a fresh policy loading a mid-run ``state_dict`` continues
    the exact trajectory (the WAL-replay law)."""
    cfg = PolicyConfig(min_batch=256, calm_ticks_to_narrow=2)
    obs_seq = [
        {"now": 10.0 + i, "window_s": 1.0, "served": 400, "throttled": t,
         "batch": 512}
        for i, t in enumerate([0, 6, 0, 0, 5, 0, 0, 0])
    ]

    def run(policy, seq):
        return [policy.decide(dict(o)) for o in seq]

    a = run(AutopilotPolicy(cfg, clock=FakeClock()), obs_seq)
    b = run(AutopilotPolicy(cfg, clock=FakeClock()), obs_seq)
    assert a == b
    # replay: snapshot after 4 ticks, resume a fresh policy from it
    p1 = AutopilotPolicy(cfg, clock=FakeClock())
    head = run(p1, obs_seq[:4])
    mid = p1.state_dict()
    p2 = AutopilotPolicy(cfg, clock=FakeClock())
    p2.load_state_dict(mid)
    assert run(p1, obs_seq[4:]) == run(p2, obs_seq[4:])
    assert head  # the head produced decisions at all (tune + shed)


def test_policy_shed_arm_scales_and_decays():
    """Sustained throttle refusals double the shed scale up to the cap;
    calm windows decay it back to 1 — classic AIMD-shaped hysteresis."""
    cfg = PolicyConfig(shed_threshold=4, max_shed_scale=8.0)
    clock = FakeClock()
    policy = AutopilotPolicy(cfg, clock=clock)
    scales = []
    for throttled in [8, 8, 8, 8, 0, 0, 0, 0]:
        clock.advance(1.0)
        policy.decide({"now": clock(), "window_s": 1.0, "served": 10,
                       "throttled": throttled, "batch": 1024,
                       "max_inflight": 64})
        scales.append(policy.state_dict()["scale"])
    assert scales[:4] == [2.0, 4.0, 8.0, 8.0]  # capped at max_shed_scale
    assert scales[-1] == 1.0                   # fully decayed when calm


def test_policy_structural_decisions():
    """The shard-map arm picks, in fixed priority: split the hottest
    qualifying shard, merge the coldest adjacent pair, migrate across a
    hot/cold boundary — with deterministic tie-breaks and one shared
    cooldown."""
    cfg = PolicyConfig(hot_factor=1.5, cold_factor=0.25, split_p99_ms=5.0,
                       struct_cooldown_s=0.0)
    clock = FakeClock()
    policy = AutopilotPolicy(cfg, clock=clock)

    def struct(shards):
        clock.advance(1.0)
        ds = policy.decide({"now": clock(), "window_s": 1.0,
                            "served": 0, "throttled": 0,
                            "shards": shards})
        return [d for d in ds if d.kind in ("split", "merge", "migrate")]

    # hot + slow + wide enough → split wins
    ds = struct({0: {"served": 300, "lo": 0, "hi": 4, "ranks": 4,
                     "p99_ms": 30.0},
                 1: {"served": 10, "lo": 4, "hi": 8, "ranks": 4,
                     "p99_ms": 1.0}})
    assert [d.kind for d in ds] == ["split"] and ds[0].target == 0
    # two cold adjacent shards fold into the lower slice
    ds = struct({0: {"served": 300, "lo": 0, "hi": 4, "ranks": 4},
                 1: {"served": 1, "lo": 4, "hi": 6, "ranks": 2},
                 2: {"served": 2, "lo": 6, "hi": 8, "ranks": 2}})
    assert [d.kind for d in ds] == ["merge"]
    assert ds[0].args == {"into": 1, "frm": 2}
    # hot-but-narrow-p99 shard next to a cold one → migrate a quarter
    ds = struct({0: {"served": 300, "lo": 0, "hi": 5, "ranks": 5,
                     "p99_ms": 0.0},
                 1: {"served": 10, "lo": 5, "hi": 8, "ranks": 3,
                     "p99_ms": 0.0}})
    assert [d.kind for d in ds] == ["migrate"]
    assert ds[0].args == {"frm": 0, "to": 1, "count": 1}


def test_policy_requires_injected_clock():
    with pytest.raises(ValueError):
        AutopilotPolicy(PolicyConfig())


# --------------------------------------------------------- backpressure
def test_backpressure_table_covers_every_typed_refusal():
    bp = BackpressurePolicy()
    for site, ms in DEFAULT_RETRY_MS.items():
        assert bp.retry_ms(site) == ms
    with pytest.raises(KeyError):
        bp.retry_ms("not_a_refusal_site")


def test_backpressure_scale_and_clamps():
    bp = BackpressurePolicy()
    base = bp.retry_ms("standby")
    bp.set_scale(4.0)
    assert bp.retry_ms("standby") == base * 4
    bp.set_scale(1e9)            # clamped to the table's max factor
    assert bp.scale == 256.0
    assert bp.retry_ms("standby") == MAX_RETRY_MS
    bp.set_scale(0.0)            # never below 1: hints only slow down
    assert bp.scale == 1.0
    bp.set("standby", 75)
    assert bp.retry_ms("standby") == 75
    rep = bp.report()
    assert rep["scale"] == 1.0 and rep["retry_ms"]["standby"] == 75


# ------------------------------------------------------ metric windows
def test_histogram_snapshot_delta_windows():
    reg = MetricsRegistry()
    h = reg.histogram("lat_ms")
    for v in (1.0, 2.0, 3.0):
        h.observe(v)
    snap = h.snapshot()
    for v in (100.0, 200.0):
        h.observe(v)
    d = h.delta(snap)
    assert d["count"] == 2
    assert d["p99_ms"] >= 100.0  # the window sees only the new samples
    full = histogram_delta(h.snapshot(), None)
    assert full["count"] == 5


def test_registry_snapshot_delta_windows():
    reg = MetricsRegistry()
    reg.inc("served", 5)
    snap = reg.snapshot()
    reg.inc("served", 3)
    reg.histogram("t_ms").observe(7.0)
    d = registry_delta(reg.snapshot(), snap)
    assert d["counters"]["served"] == 3
    assert d["histograms"]["t_ms"]["count"] == 1


# ------------------------------------------------------------ knob arm
def test_knob_rail_is_zero_protocol_bytes_until_a_controller_acts():
    """With no autopilot attached the wire is byte-identical to the
    pre-autopilot build: WELCOME carries no ``batch_hint``, heartbeat
    replies carry no ``knobs`` — until ``set_autopilot_knobs`` flips
    the advertisement on."""
    spec = PartialShuffleSpec.plain(2048, window=128, world=2, backend=BACKEND)
    with IndexServer(spec, port=0) as srv:
        with ServiceIndexClient(srv.address, rank=0, batch=64,
                                spec=spec) as c:
            c.set_epoch(0)
            assert c._batch_hint is None
            assert c.heartbeat() is not None
            assert c._batch_hint is None
            assert c._server_max_inflight == srv.max_inflight
            srv.set_autopilot_knobs(max_inflight=4, batch_hint=128)
            c.heartbeat()
            assert c._server_max_inflight == 4
            assert c._batch_hint == 128


def test_controller_tunes_live_server_and_client_adopts():
    """End-to-end knob loop: the controller observes a hot RPC rate,
    emits a tune, the knobs ride the heartbeat, and an ``auto_batch``
    client adopts the larger batch at the next epoch boundary — the
    folded epoch stays bit-identical."""
    spec = PartialShuffleSpec.plain(4096, window=256, world=2, backend=BACKEND)
    clock = FakeClock()
    with IndexServer(spec, port=0) as srv:
        ap = Autopilot(server=srv, clock=clock,
                       config=PolicyConfig(min_batch=64, target_rpc_per_s=1.0))
        with ServiceIndexClient(srv.address, rank=0, batch=64, spec=spec,
                                auto_batch=True) as c:
            c.set_epoch(0)
            e0 = np.concatenate(list(c.epoch_batches(0)))
            clock.advance(1.0)
            decisions = ap.tick()
            assert [d.kind for d in decisions] == ["tune"]
            assert decisions[0].args["batch_hint"] == 128
            c.heartbeat()
            assert c._batch_hint == 128
            c.set_epoch(1)
            e1 = np.concatenate(list(c.epoch_batches(1)))
            assert c.batch == 128, "client never adopted the tuned batch"
            # a transport-batch change never changes served bits
            assert np.array_equal(e0, np.asarray(spec.rank_indices(0, 0)))
            assert np.array_equal(e1, np.asarray(spec.rank_indices(1, 0)))
        st = ap.status()
        assert st["batch_hint"] == 128
        assert st["policy"]["seq"] == 1
        reg = srv.metrics.registry.report()["counters"]
        assert reg["autopilot_decisions"] == 1
        assert reg["autopilot_tunes"] == 1


def test_controller_shed_scales_backpressure_table():
    """A throttle storm observed by the controller scales every typed
    ``retry_ms`` hint through the shared ``BackpressurePolicy``; the
    tenant engines see the same scaled table (one object, not copies)."""
    spec = PartialShuffleSpec.plain(1024, window=64, world=2, backend=BACKEND)
    clock = FakeClock()
    with IndexServer(spec, port=0) as srv:
        ap = Autopilot(server=srv, clock=clock,
                       config=PolicyConfig(shed_threshold=1))
        base = srv.backpressure.retry_ms("throttle")
        srv.metrics.registry.inc("throttled", 8)
        clock.advance(1.0)
        kinds = [d.kind for d in ap.tick()]
        assert "shed" in kinds
        assert srv.backpressure.retry_ms("throttle") == base * 2
        # calm window decays the scale back toward 1
        clock.advance(1.0)
        ap.tick()
        assert srv.backpressure.retry_ms("throttle") == base


# -------------------------------------------------------- elastic plane
def _epoch(addr, rank, spec, epoch, **kw):
    kw.setdefault("batch", 64)
    kw.setdefault("backoff_base", 0.01)
    with ServiceIndexClient(addr, rank=rank, spec=spec, **kw) as c:
        if rank == 0:
            c.set_epoch(epoch)
        return np.concatenate(list(c.epoch_batches(epoch)))


def _single_server_ref(spec, epochs):
    ref = {}
    with IndexServer(spec, port=0) as srv:
        for e in epochs:
            for r in range(spec.world):
                ref[(e, r)] = _epoch(srv.address, r, spec, e)
    return ref


def test_split_under_hotspot_without_operator_action():
    """Drive a skewed load (only shard 0's ranks stream), let the
    controller observe the hotspot and split it — no operator call —
    then verify the next epoch is still bit-identical to a static
    single server."""
    spec = PartialShuffleSpec.plain(4096, window=256, world=8, backend=BACKEND)
    ref = _single_server_ref(spec, epochs=(0, 1))
    clock = FakeClock()
    with ShardPlane(spec, 2) as plane:
        ap = Autopilot(
            plane=plane, clock=clock,
            config=PolicyConfig(hot_factor=1.5, split_p99_ms=0.0,
                                struct_cooldown_s=0.0,
                                target_rpc_per_s=1e9))
        clock.advance(1.0)
        ap.tick()                       # baseline window (no decision data)
        # hotspot: shard 0 owns ranks 0..3; only those stream epoch 0
        for r in range(4):
            assert np.array_equal(
                _epoch(plane.address, r, spec, 0), ref[(0, r)])
        clock.advance(1.0)
        decisions = ap.tick()
        kinds = [d.kind for d in decisions]
        assert "split" in kinds, f"no split under hotspot: {decisions}"
        assert plane.map.n_shards == 3
        assert plane.map.version >= 2
        # every rank's NEXT epoch is bit-identical on the wider plane
        for r in range(8):
            assert np.array_equal(
                _epoch(plane.address, r, spec, 1), ref[(1, r)])
        reg = plane.shards[0].metrics.registry.report()["counters"]
        assert reg["autopilot_splits"] == 1


def test_merge_and_migrate_streams_bit_identical():
    """Fold a 3-shard plane down to 2 (merge), then shift boundary
    ranks (migrate): every epoch folded across both transforms is
    bit-identical to a static single ``IndexServer``; clients that were
    attached to the merged-out shard re-route themselves."""
    spec = PartialShuffleSpec.plain(4096, window=256, world=6, backend=BACKEND)
    ref = _single_server_ref(spec, epochs=(0, 1, 2))
    with ShardPlane(spec, 3) as plane:
        for r in range(6):
            assert np.array_equal(
                _epoch(plane.address, r, spec, 0), ref[(0, r)])
        plane.merge_shards(1, 2)
        assert plane.map.n_shards == 3  # slot kept, slice emptied
        assert sum(1 for lo, hi in plane.map.slices if hi > lo) == 2
        for r in range(6):
            assert np.array_equal(
                _epoch(plane.address, r, spec, 1), ref[(1, r)])
        plane.migrate_ranks(0, 1, 1)
        for r in range(6):
            assert np.array_equal(
                _epoch(plane.address, r, spec, 2), ref[(2, r)])


def test_migration_moves_live_cursors_mid_epoch():
    """A client streaming THROUGH a migration keeps its exactly-once
    cursor: the WAL-replay handoff moves the cursor to the new owner
    and the ``wrong_shard`` redirect lands the client on it."""
    spec = PartialShuffleSpec.plain(4096, window=256, world=4, backend=BACKEND)
    ref = _single_server_ref(spec, epochs=(0,))
    with ShardPlane(spec, 2) as plane:
        with ServiceIndexClient(plane.address, rank=1, batch=64, spec=spec,
                                backoff_base=0.01) as c:
            c.set_epoch(0)
            it = c.epoch_batches(0)
            got = [next(it), next(it)]
            plane.migrate_ranks(0, 1, 1)    # rank 1 changes owner mid-epoch
            got.extend(it)
            assert np.array_equal(np.concatenate(got), ref[(0, 1)])
            counters = c.metrics.report()["counters"]
            assert counters.get("wrong_shard_redirects", 0) >= 1


# ---------------------------------------------------------- WAL replay
def test_promoted_standby_inherits_controller_state():
    """Tune decisions are WAL-logged with the policy's state; after the
    primary dies and the standby promotes, a controller attached to the
    promoted server RESUMES the trajectory (same seq, same knobs) — the
    replayed decisions are the logged ones, not a restart from zero."""
    spec = PartialShuffleSpec.plain(2048, window=128, world=2, backend=BACKEND)
    primary, standby = replicated_pair(spec)
    clock = FakeClock()
    try:
        ap = Autopilot(server=primary, clock=clock,
                       config=PolicyConfig(min_batch=64,
                                           target_rpc_per_s=1.0))
        with ServiceIndexClient(primary.address, rank=0, batch=64,
                                spec=spec) as c:
            c.set_epoch(0)
            list(c.epoch_batches(0))
            clock.advance(1.0)
            ap.tick()
            clock.advance(1.0)
            list(c.epoch_batches(0))
            ap.tick()
        want = ap.policy.state_dict()
        assert want["seq"] >= 1 and want["batch_hint"] is not None
        wait_synced(primary, standby)
        primary.kill()
        # promote once the feed is observably stale (what a failing-over
        # client's HELLO would trigger)
        wait_for(lambda: standby._try_promote() or
                 standby.role == "primary")
        # the mirror applied the autopilot records: knobs + state both
        assert standby.autopilot_state() == want
        assert standby._batch_hint == want["batch_hint"]
        ap2 = Autopilot(server=standby, clock=clock)
        assert ap2.policy.state_dict() == want
        nxt = ap2.policy._emit("tune")
        assert nxt.seq == want["seq"] + 1   # continues, never restarts
    finally:
        primary.kill()
        standby.stop()


# --------------------------------------------------------------- chaos
@pytest.mark.chaos
def test_chaos_decide_fault_skips_one_tick():
    """An injected ``autopilot.decide`` fault costs exactly one tick:
    counted, no decision, no crash — and the next tick proceeds."""
    spec = PartialShuffleSpec.plain(1024, window=64, world=2, backend=BACKEND)
    clock = FakeClock()
    with IndexServer(spec, port=0) as srv:
        ap = Autopilot(server=srv, clock=clock,
                       config=PolicyConfig(min_batch=64,
                                           target_rpc_per_s=1.0))
        with ServiceIndexClient(srv.address, rank=0, batch=64,
                                spec=spec) as c:
            c.set_epoch(0)
            list(c.epoch_batches(0))
            with F.FaultPlan([F.FaultRule("autopilot.decide",
                                          "error")]) as plan:
                clock.advance(1.0)
                assert ap.tick() == []
                assert plan.fired("autopilot.decide") == 1
            reg = srv.metrics.registry.report()["counters"]
            assert reg["autopilot_decide_errors"] == 1
            list(c.epoch_batches(0))
            clock.advance(1.0)
            assert [d.kind for d in ap.tick()] == ["tune"]


@pytest.mark.chaos
def test_chaos_split_fault_leaves_map_unchanged():
    """A fault at ``shard.split`` aborts the split atomically: the map
    keeps its version, streams keep serving, and a retry succeeds."""
    spec = PartialShuffleSpec.plain(2048, window=128, world=4, backend=BACKEND)
    with ShardPlane(spec, 2) as plane:
        v0, n0 = plane.map.version, plane.map.n_shards
        with F.FaultPlan([F.FaultRule("shard.split", "error")]) as plan:
            with pytest.raises(F.InjectedFault):
                plane.split_shard(0)
            assert plan.fired("shard.split") == 1
        assert (plane.map.version, plane.map.n_shards) == (v0, n0)
        assert _epoch(plane.address, 0, spec, 0).size > 0
        assert plane.split_shard(0) == 2     # clean retry goes through


@pytest.mark.chaos
def test_chaos_migrate_fault_aborts_two_phase_handoff():
    """A fault at ``shard.migrate`` (the router's two-phase remap)
    aborts the handoff: no shard adopts the new map, the frozen ranks
    thaw, and the same migration succeeds on retry."""
    spec = PartialShuffleSpec.plain(2048, window=128, world=4, backend=BACKEND)
    ref = _single_server_ref(spec, epochs=(0,))
    with ShardPlane(spec, 2) as plane:
        v0 = plane.map.version
        with F.FaultPlan([F.FaultRule("shard.migrate", "error")]) as plan:
            with pytest.raises(F.InjectedFault):
                plane.migrate_ranks(0, 1, 1)
            assert plan.fired("shard.migrate") == 1
        assert plane.map.version == v0
        for srv in plane.shards:
            assert srv.shard_map.version == v0
            assert not srv._migrating
        plane.migrate_ranks(0, 1, 1)
        for r in range(4):
            assert np.array_equal(
                _epoch(plane.address, r, spec, 0), ref[(0, r)])


@pytest.mark.chaos
def test_chaos_failed_actuation_not_wal_logged():
    """A decision whose actuation dies (injected ``shard.split`` fault)
    is counted and dropped — never WAL-logged, so a replayed standby
    cannot re-apply a move that never happened."""
    spec = PartialShuffleSpec.plain(4096, window=256, world=8, backend=BACKEND)
    clock = FakeClock()
    with ShardPlane(spec, 2) as plane:
        ap = Autopilot(
            plane=plane, clock=clock,
            config=PolicyConfig(hot_factor=1.5, split_p99_ms=0.0,
                                struct_cooldown_s=0.0,
                                target_rpc_per_s=1e9))
        clock.advance(1.0)
        ap.tick()
        for r in range(4):
            _epoch(plane.address, r, spec, 0)
        with F.FaultPlan([F.FaultRule("shard.split", "error")]) as plan:
            clock.advance(1.0)
            actuated = ap.tick()
            assert plan.fired("shard.split") == 1
        assert all(d.kind != "split" for d in actuated)
        assert plane.map.n_shards == 2
        lead = plane.shards[0]
        assert lead.autopilot_state() is None or \
            lead.metrics.registry.report()["counters"].get(
                "autopilot_splits", 0) == 0
        assert lead.metrics.registry.report()["counters"][
            "autopilot_decide_errors"] >= 1


# ------------------------------------------------- across the two packages
def _hotspot_trace(seed):
    """A JAX-package simulated hotspot's observation stream (the
    scenario of the fleetsim suite's parity law)."""
    cfg = dict(min_batch=256, max_batch=256, min_inflight=2,
               max_inflight=4, hot_factor=1.5, split_p99_ms=0.2,
               struct_cooldown_s=3.0, target_rpc_per_s=1e9)
    sim = jfs.FleetSim(
        world=8, n_shards=2, n=4096,
        workload=jfs.workload.hotspot(1000.0, hot_lo=0, hot_hi=4,
                                      factor=10.0, at_s=3.0, ramp_s=4.0,
                                      key="parity-wl"),
        seed=seed, config=JA.PolicyConfig(**cfg), batch0=256,
        backend="cpu",
        latency=jfs.LatencyModel(seed=seed, calibration=jfs.Calibration(
            rpc=(40.0, 0.05))))
    sim.run(12)
    return cfg, [e["obs"] for e in sim.trace.entries]


@pytest.mark.parametrize("backend", ["cpu", "native"])
def test_live_controllers_equal_across_packages(backend, tmp_path):
    """One observation stream through a live two-shard plane of each
    package (the port's specs on ``backend``): the same decisions, the
    same actuated maps, and WAL records equal field for field, each
    package reading the other's."""
    cfg, stream = _hotspot_trace(23)
    jspec = JS.PartialShuffleSpec.plain(4096, window=256, world=8)
    spec = PartialShuffleSpec.from_wire(jspec.to_wire(), backend=backend)
    runs = {}
    for name, plane_cls, A, P_cfg, sp in (
            ("jax", JSH.ShardPlane, JA.Autopilot, JA.PolicyConfig, jspec),
            ("port", ShardPlane, Autopilot, PolicyConfig, spec)):
        obs = iter(json.loads(json.dumps(stream)))
        wal = str(tmp_path / name)
        with plane_cls(sp, 2, wal_dir=wal) as plane:
            policy_cls = (JA.AutopilotPolicy if name == "jax"
                          else AutopilotPolicy)
            ap = A(plane=plane, clock=lambda: 0.0,
                   policy=policy_cls(P_cfg(**cfg), clock=lambda: 0.0,
                                     seed=23),
                   observe=lambda: next(obs, None),
                   backend_probe=lambda n: ("cpu", None))
            to_dict = (jfs.decision_to_dict if name == "jax"
                       else decision_to_dict)
            decisions = [[to_dict(d) for d in ap.tick()]
                         for _ in range(len(stream))]
            m = plane.map
            runs[name] = (decisions, (m.version, m.world, m.slices), wal)
    assert runs["port"][0] == runs["jax"][0]
    assert runs["port"][1] == runs["jax"][1]
    assert any(d["kind"] == "split" for t in runs["port"][0] for d in t)
    for reader in (read_autopilot_records, JD.read_autopilot_records):
        assert reader(f"{runs['port'][2]}/0") == \
            reader(f"{runs['jax'][2]}/0")
        assert reader(f"{runs['port'][2]}/0")


def test_pick_backend_without_a_card_is_the_host_backend():
    """Past the probe's size gate (C4's 1e9/256 samples a rank) the
    controller asks the port's ``utils/autotune.pick_backend``; with no
    card it answers the host backend and runs no device probe."""
    import torch

    from partiallyshuffledistributedsampler_tpu_torch.ops import (
        resolve_host_backend,
    )
    from partiallyshuffledistributedsampler_tpu_torch.utils import autotune

    if torch.cuda.is_available():
        pytest.skip("the card's answer is held in test_torch_port_gpu.py")

    class _Lead:
        spec = PartialShuffleSpec.plain(1_000_000_000, window=8192,
                                        world=256, backend=BACKEND)

    assert 1_000_000_000 // 256 > Autopilot.BACKEND_PROBE_MIN_SAMPLES
    spec = PartialShuffleSpec.plain(2048, window=128, world=2,
                                    backend=BACKEND)
    with ShardPlane(spec, 1) as plane:
        ap = Autopilot(plane=plane, clock=FakeClock())
        assert ap._pick_backend(_Lead) == resolve_host_backend()
        assert ap._backend_gain is None
    assert autotune.cost_model() is None
