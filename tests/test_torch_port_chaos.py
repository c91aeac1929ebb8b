"""The port's counterpart of the JAX package's ``tests/test_chaos.py``.

Every case runs on ``partiallyshuffledistributedsampler_tpu_torch`` with its
specs and loaders on ``backend="cpu"`` (no card), under the port's
lock-order sanitizer; the JAX file's text follows.

Deterministic fault-injection matrix for the served-index stack.

The contract under test (docs/RESILIENCE.md): for every fault site and
every stream mode, the consumer sees either a bit-identical stream or a
typed error within its deadline — never a hang, never silently-wrong
indices.  Every test asserts ``plan.fired(...) > 0``: a chaos test whose
fault never fired is vacuous and must fail.

These run inside tier-1 (they are fast and fully deterministic) and are
also the first leg of the ``make chaos-smoke`` gate (``-m chaos``).
"""

from __future__ import annotations

import random
import socket
import threading
import time
import warnings

import numpy as np
import pytest

from partiallyshuffledistributedsampler_tpu_torch import faults as F
from partiallyshuffledistributedsampler_tpu_torch.durability import WriteAheadLog
from partiallyshuffledistributedsampler_tpu_torch.ops.mixture import MixtureSpec
from partiallyshuffledistributedsampler_tpu_torch.sampler.host_loader import (
    HostDataLoader,
)
from partiallyshuffledistributedsampler_tpu_torch.service import (
    IndexServer,
    PartialShuffleSpec,
    ServiceIndexClient,
)
from partiallyshuffledistributedsampler_tpu_torch.service import protocol as P
from partiallyshuffledistributedsampler_tpu_torch.service.client import (
    ServiceUnavailable,
)
from partiallyshuffledistributedsampler_tpu_torch.utils import (
    RetryPolicy,
    StallError,
)

from partiallyshuffledistributedsampler_tpu_torch.analysis import lockorder

#: every port spec and loader of this file regenerates on the host
BACKEND = "cpu"


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

pytestmark = pytest.mark.chaos


# ----------------------------------------------------------- stream builders
def plain_spec(world=1):
    return PartialShuffleSpec.plain(530, window=32, seed=7, world=world, backend=BACKEND)


def mixture_spec(world=1):
    ms = MixtureSpec([100, 200, 50], [5, 3, 2], block=16)
    return PartialShuffleSpec.mixture(ms, seed=3, world=world,
                                      epoch_samples=300, backend=BACKEND)


def shard_spec(world=1):
    return PartialShuffleSpec.shard([17, 5, 29, 11, 40, 8, 23, 9], window=4,
                                    seed=9, world=world,
                                    within_shard_shuffle=True, backend=BACKEND)


SPECS = {"plain": plain_spec, "mixture": mixture_spec, "shard": shard_spec}


def make_loader(mode, **kw):
    """A small HostDataLoader in each stream mode (world=1, rank 0)."""
    if mode == "plain":
        X = np.arange(530, dtype=np.int64)
        return HostDataLoader(X, window=32, batch=64, seed=7, rank=0,
                              world=1, **kw, index_backend=BACKEND, device="cpu")
    if mode == "mixture":
        ms = MixtureSpec([100, 200, 50], [5, 3, 2], block=16)
        data = [np.arange(100, dtype=np.int64),
                np.arange(200, dtype=np.int64),
                np.arange(50, dtype=np.int64)]
        return HostDataLoader(data, mixture=ms, epoch_samples=300, batch=64,
                              seed=3, rank=0, world=1, **kw, index_backend=BACKEND, device="cpu")
    sizes = [17, 5, 29, 11, 40, 8, 23, 9]
    X = np.arange(sum(sizes), dtype=np.int64)
    return HostDataLoader(X, shard_sizes=sizes, window=4, batch=32, seed=9,
                          rank=0, world=1, **kw, index_backend=BACKEND, device="cpu")


def collect(loader, epoch=0):
    return [np.asarray(b) for b in loader.epoch(epoch)]


def _raw_hello(addr, rank, batch=32):
    sock = socket.create_connection(addr, timeout=5.0)
    P.send_msg(sock, P.MSG_HELLO,
               {"proto": P.PROTOCOL_VERSION, "rank": rank, "batch": batch})
    msg, header, _ = P.recv_msg(sock)
    return sock, msg, header


# ------------------------------------------------------- plan/rule mechanics
def test_fault_rule_validation():
    with pytest.raises(ValueError):
        F.FaultRule(site="nope", kind="error")
    with pytest.raises(ValueError):
        F.FaultRule(site="loader.regen", kind="nope")
    with pytest.raises(ValueError):
        F.FaultRule(site="loader.regen", kind="error", nth=0)
    with pytest.raises(ValueError):
        F.FaultRule(site="loader.regen", kind="error", every=0)


def test_fault_plan_counters_are_deterministic():
    def run():
        plan = F.FaultPlan([F.FaultRule(site="loader.regen", kind="error",
                                        nth=2, every=3, count=2)])
        return [plan.draw("loader.regen") is not None for _ in range(12)]

    a, b = run(), run()
    assert a == b
    # nth=2, every=3, count=2 -> fires at exactly hits 2 and 5
    assert [i + 1 for i, fired in enumerate(a) if fired] == [2, 5]


def test_fault_plan_probabilistic_is_seed_reproducible():
    def run(seed):
        plan = F.FaultPlan([F.FaultRule(site="loader.regen", kind="error",
                                        p=0.5, count=0)], seed=seed)
        return [plan.draw("loader.regen") is not None for _ in range(64)]

    assert run(1) == run(1)
    assert run(1) != run(2)
    assert 0 < sum(run(3)) < 64  # actually probabilistic, not all-or-nothing


def test_fault_plan_json_and_env_roundtrip(monkeypatch):
    plan = F.FaultPlan([F.FaultRule(site="service.send", kind="torn_frame",
                                    nth=3)], seed=5)
    back = F.FaultPlan.from_json(plan.to_json())
    assert back.rules == plan.rules and back.seed == plan.seed
    monkeypatch.setenv("PSDS_FAULT_PLAN", plan.to_json())
    env_plan = F.FaultPlan.from_env()
    assert env_plan is not None and env_plan.rules == plan.rules
    monkeypatch.delenv("PSDS_FAULT_PLAN")
    assert F.FaultPlan.from_env() is None


def test_plans_nest_lifo_and_unarmed_draw_is_none():
    assert F.draw("loader.regen") is None  # fast path: no plan, no effect
    outer = F.FaultPlan([F.FaultRule(site="loader.regen", kind="error")])
    inner = F.FaultPlan([F.FaultRule(site="loader.prefetch", kind="delay")])
    with outer:
        assert F.active() is outer
        with inner:
            assert F.active() is inner
        assert F.active() is outer
    assert F.draw("loader.regen") is None


# ------------------------------------------------------------- retry policy
class FakeTime:
    def __init__(self):
        self.t = 0.0
        self.sleeps = []

    def clock(self):
        return self.t

    def sleep(self, s):
        self.sleeps.append(s)
        self.t += s


def test_retry_backoff_jitter_stays_inside_envelope():
    ft = FakeTime()
    pol = RetryPolicy(base=0.1, max_delay=0.4, deadline=None,
                      clock=ft.clock, sleep=ft.sleep,
                      rng=random.Random(0))
    for k in range(10):
        d = pol.backoff(k)
        assert 0.0 <= d <= min(0.4, 0.1 * 2.0 ** k)


def test_retry_deadline_refuses_to_oversleep():
    ft = FakeTime()
    pol = RetryPolicy(base=0.1, max_delay=0.4, deadline=1.0,
                      clock=ft.clock, sleep=ft.sleep,
                      rng=random.Random(1))
    op = pol.begin()
    while op.pause():
        pass
    assert ft.t <= 1.0  # never slept past the operation deadline
    assert op.attempts >= 1


def test_retry_budget_caps_attempts():
    ft = FakeTime()
    pol = RetryPolicy(base=0.0, max_delay=0.0, deadline=None, budget=3,
                      clock=ft.clock, sleep=ft.sleep)
    op = pol.begin()
    assert [op.pause() for _ in range(4)] == [True, True, True, False]


def test_retry_pause_honors_server_suggested_minimum():
    ft = FakeTime()
    pol = RetryPolicy(base=0.0, max_delay=0.0, deadline=None,
                      clock=ft.clock, sleep=ft.sleep)
    op = pol.begin()
    assert op.pause(min_delay=0.2)
    assert ft.sleeps == [0.2]


def test_circuit_breaker_open_halfopen_reopen_close():
    ft = FakeTime()
    pol = RetryPolicy(breaker_threshold=2, breaker_reset=1.0,
                      clock=ft.clock, sleep=ft.sleep)
    assert pol.allow()
    pol.record_failure()
    assert pol.allow()  # below threshold
    pol.record_failure()
    assert not pol.allow()  # open
    ft.t += 1.0
    assert pol.allow()  # half-open probe admitted
    pol.record_failure()
    assert not pol.allow()  # failed probe re-opens a fresh interval
    ft.t += 1.0
    assert pol.allow()
    pol.record_success()
    assert pol.allow() and not pol.circuit_open  # closed


# ------------------------------------------------- service-side fault matrix
# (site, kind, rule kwargs) — nth skips the handshake so faults land mid-
# stream; counts are finite so every scenario must terminate
_SERVICE_FAULTS = [
    ("service.send", "torn_frame", dict(nth=2, count=1)),
    ("service.send", "reset", dict(nth=2, count=1)),
    ("service.send", "delay", dict(nth=2, count=2, delay_s=0.01)),
    ("service.recv", "reset", dict(nth=2, count=1)),
    ("service.recv", "corrupt", dict(nth=2, count=1)),
    ("server.dispatch", "thread_death", dict(nth=2, count=1)),
    ("server.snapshot_write", "disk_full", dict(nth=1, count=2)),
    # the pipelined window's coalesced top-up send: a reset tears the
    # connection with a full lookahead of unacked requests in flight,
    # a delay stretches it — either way the guarded path must replay
    # the window exactly-once
    ("client.pipeline", "reset", dict(nth=1, count=1)),
    ("client.pipeline", "delay", dict(nth=2, count=2, delay_s=0.01)),
]


@pytest.mark.parametrize("mode", sorted(SPECS))
@pytest.mark.parametrize(
    "site,kind,rule_kw", _SERVICE_FAULTS,
    ids=[f"{s}-{k}" for s, k, _ in _SERVICE_FAULTS])
def test_service_fault_matrix_stream_bit_identical(mode, site, kind, rule_kw,
                                                   tmp_path):
    spec = SPECS[mode](world=1)
    ref = np.asarray(spec.rank_indices(1, 0))
    plan = F.FaultPlan([F.FaultRule(site=site, kind=kind, **rule_kw)])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with plan:
            with IndexServer(spec, snapshot_path=str(tmp_path / "snap.json"),
                             snapshot_interval=1) as srv:
                with ServiceIndexClient(srv.address, rank=0, batch=37,
                                        backoff_base=0.01,
                                        reconnect_timeout=10.0) as client:
                    got = client.epoch_indices(1)
    assert plan.fired(site) > 0, "fault never fired; the test is vacuous"
    assert np.array_equal(got, ref), f"stream diverged under {kind} at {site}"
    if kind == "corrupt":
        counters = client.metrics.report()["counters"]
        assert counters.get("checksum_rejects", 0) >= 1
    if kind == "disk_full":
        assert srv.metrics.report()["counters"].get("snapshot_errors", 0) >= 1


def test_persistent_corruption_is_a_typed_error():
    spec = plain_spec(world=1)
    # every reply corrupted: re-requesting cannot help; the client must
    # give up with the typed checksum error, not loop forever
    plan = F.FaultPlan([F.FaultRule(site="service.recv", kind="corrupt",
                                    count=0)])
    t0 = time.monotonic()
    with IndexServer(spec) as srv, plan:
        with ServiceIndexClient(srv.address, rank=0, batch=37) as client:
            with pytest.raises(P.ChecksumError):
                client.epoch_indices(1)
    assert plan.fired("service.recv") >= 2
    assert time.monotonic() - t0 < 10.0


@pytest.mark.parametrize("mode", sorted(SPECS))
@pytest.mark.parametrize("kind", ["torn_frame", "reset"])
def test_ack_carrying_request_torn_mid_flight_exactly_once(mode, kind):
    """The coalesced GET_BATCH frames each carry the delivered-ack
    cursor.  Tearing that send mid-flight (after epoch 1 delivered, so
    the lost frames carry real ack state) must not double-serve or drop
    anything: the cursor only advanced on yield, so the replay through
    the guarded path keeps both epochs bit-identical."""
    spec = SPECS[mode](world=1)
    # nth high enough to land mid-stream of the second epoch's window
    plan = F.FaultPlan([F.FaultRule(site="service.send", kind=kind,
                                    nth=4, count=1)])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with plan:
            with IndexServer(spec) as srv:
                with ServiceIndexClient(srv.address, rank=0, batch=37,
                                        lookahead=4, backoff_base=0.01,
                                        reconnect_timeout=10.0) as client:
                    got1 = client.epoch_indices(1)
                    got2 = client.epoch_indices(2)
    assert plan.fired("service.send") > 0, "fault never fired; vacuous"
    assert np.array_equal(got1, np.asarray(spec.rank_indices(1, 0)))
    assert np.array_equal(got2, np.asarray(spec.rank_indices(2, 0)))


# --------------------------------------------------- loader-side fault matrix
@pytest.mark.parametrize("mode", sorted(SPECS))
def test_loader_prefetch_delay_stream_identical(mode):
    ref = collect(make_loader(mode))
    plan = F.FaultPlan([F.FaultRule(site="loader.prefetch", kind="delay",
                                    nth=2, count=2, delay_s=0.01)])
    with plan:
        got = collect(make_loader(mode))
    assert plan.fired("loader.prefetch") > 0
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("mode", sorted(SPECS))
def test_loader_prefetch_thread_death_raises_stall(mode):
    loader = make_loader(mode, stall_timeout=2.0)
    plan = F.FaultPlan([F.FaultRule(site="loader.prefetch",
                                    kind="thread_death", nth=2)])
    t0 = time.monotonic()
    with plan:
        with pytest.raises(StallError) as ei:
            collect(loader)
    assert plan.fired("loader.prefetch") == 1
    assert time.monotonic() - t0 < 10.0  # typed error, not a hang
    assert ei.value.thread_alive is False


@pytest.mark.parametrize("mode", sorted(SPECS))
def test_loader_regen_fault_is_typed(mode):
    loader = make_loader(mode)
    with F.FaultPlan([F.FaultRule(site="loader.regen",
                                  kind="error")]) as plan:
        with pytest.raises(F.InjectedFault) as ei:
            loader.epoch_indices(0)
    assert plan.fired("loader.regen") == 1
    assert ei.value.site == "loader.regen"


@pytest.mark.parametrize("mode", sorted(SPECS))
@pytest.mark.parametrize("kind", ["thread_death", "error", "delay"])
def test_loader_boundary_prefetch_fault_recomputes_foreground(mode, kind):
    """The epoch-boundary prefetch worker is advisory: killing it,
    failing it, or delaying it must leave every epoch's stream identical
    — the boundary just recomputes in the foreground."""
    ref_loader = make_loader(mode)
    ref = [collect(ref_loader, e) for e in range(3)]
    kw = dict(nth=1, count=2)
    if kind == "delay":
        kw["delay_s"] = 0.01
    plan = F.FaultPlan([F.FaultRule(site="loader.boundary", kind=kind,
                                    **kw)])
    with plan:
        loader = make_loader(mode)
        got = [collect(loader, e) for e in range(3)]
    assert plan.fired("loader.boundary") > 0, "fault never fired; vacuous"
    for e in range(3):
        assert len(got[e]) == len(ref[e])
        for a, b in zip(got[e], ref[e]):
            assert np.array_equal(a, b), (
                f"boundary fault changed epoch {e} ({mode}/{kind})")


def test_loader_stall_watchdog_on_wedged_producer():
    """A producer wedged (not dead) past stall_timeout surfaces a
    StallError embedding the stuck thread's stack."""
    loader = make_loader("plain", stall_timeout=0.3)
    plan = F.FaultPlan([F.FaultRule(site="loader.prefetch", kind="delay",
                                    nth=1, count=1, delay_s=1.5)])
    with plan:
        with pytest.raises(StallError) as ei:
            collect(loader)
    assert plan.fired("loader.prefetch") == 1
    assert ei.value.thread_alive is True
    assert "stack of stalled thread" in str(ei.value)


# -------------------------------------------------- degraded mode + re-attach
def test_degraded_fallback_mid_epoch_then_reattach():
    X = np.arange(530, dtype=np.int64)
    local = HostDataLoader(X, window=32, batch=64, seed=7, rank=0, world=1, index_backend=BACKEND, device="cpu")
    with IndexServer(plain_spec(world=1)) as srv:
        client = ServiceIndexClient(srv.address, rank=0, batch=37,
                                    backoff_base=0.01,
                                    reconnect_timeout=0.3)
        loader = HostDataLoader(X, window=32, batch=64, seed=7, rank=0,
                                world=1, index_client=client,
                                reattach_interval=0.05, index_backend=BACKEND, device="cpu")
        try:
            # healthy epoch first: service stream == local stream
            assert np.array_equal(loader.epoch_indices(0),
                                  local.epoch_indices(0))
            assert not loader.degraded
            # now every reply resets: the daemon is effectively dead
            # mid-epoch, past the client's reconnect deadline
            plan = F.FaultPlan([F.FaultRule(site="service.recv",
                                            kind="reset", count=0)])
            with plan:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    got = loader.epoch_indices(1)
            assert plan.fired("service.recv") > 0
            assert loader.degraded
            assert any("index service unavailable" in str(w.message)
                       for w in caught)
            assert np.array_equal(got, local.epoch_indices(1))
            counters = client.metrics.report()["counters"]
            assert counters.get("degraded_mode", 0) >= 1
            # the daemon is healthy again (plan disarmed): past the
            # re-attach interval the next epoch probes and re-attaches
            time.sleep(0.06)
            back = loader.epoch_indices(2)
            assert not loader.degraded
            assert np.array_equal(back, local.epoch_indices(2))
            counters = client.metrics.report()["counters"]
            assert counters.get("reattached", 0) >= 1
        finally:
            client.close()


def test_degraded_fallback_off_raises_typed_error():
    X = np.arange(530, dtype=np.int64)
    srv = IndexServer(plain_spec(world=1))
    srv.start()
    client = ServiceIndexClient(srv.address, rank=0, batch=37,
                                backoff_base=0.01, reconnect_timeout=0.2)
    loader = HostDataLoader(X, window=32, batch=64, seed=7, rank=0,
                            world=1, index_client=client,
                            degraded_fallback=False, index_backend=BACKEND, device="cpu")
    try:
        assert loader.epoch_indices(0) is not None
        srv.stop()
        with pytest.raises(ServiceUnavailable):
            loader.epoch_indices(1)
        assert not loader.degraded
    finally:
        client.close()


# ----------------------------------------------------------- graceful drain
def test_drain_replies_structured_error_then_stop_leaks_no_threads():
    srv = IndexServer(plain_spec(world=1))
    srv.start()
    sock, msg, _ = _raw_hello(srv.address, rank=0)
    try:
        assert msg == P.MSG_WELCOME
        srv._draining.set()  # the stop() drain window, held open
        P.send_msg(sock, P.MSG_GET_BATCH,
                   {"rank": 0, "epoch": 0, "seq": 0, "ack": -1})
        msg, header, _ = P.recv_msg(sock)
        assert msg == P.MSG_ERROR and header["code"] == "draining"
        assert header["retry_ms"] > 0
    finally:
        sock.close()
    srv.stop()
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith("psds-service") and t.is_alive()]
    assert not alive, f"stop() leaked serve threads: {alive}"


def test_client_survives_drain_window_across_restart():
    """A stop() with a long drain window answers in-flight requests with
    ``draining`` and the retrying client completes bit-identically once
    the server is back."""
    spec = plain_spec(world=1)
    ref = np.asarray(spec.rank_indices(1, 0))
    srv = IndexServer(spec)
    srv.start()
    client = ServiceIndexClient(srv.address, rank=0, batch=37,
                                backoff_base=0.01, reconnect_timeout=10.0)
    got = []

    def bounce():
        srv.stop(drain_s=0.2)
        srv.start()  # same instance re-binds the same port

    try:
        it = client.epoch_batches(1)
        for _ in range(3):
            got.append(next(it))
        bouncer = threading.Thread(target=bounce)
        bouncer.start()
        time.sleep(0.05)  # land the next requests inside the drain window
        got.extend(it)  # rides draining replies, reconnects, finishes
        bouncer.join()
    finally:
        client.close()
        srv.stop()
    assert np.array_equal(np.concatenate(got), ref)


# ------------------------------------------------- elastic membership faults
# (site, kind, rule kwargs): nth=1 lands on the barrier trigger, nth=2 on
# the commit (which fires only once every drain participant arrived) —
# both before any state mutation, so a retry always finds clean state
_ELASTIC_FAULTS = [
    ("server.reshard", "delay", dict(nth=1, count=2, delay_s=0.01)),
    ("server.reshard", "reset", dict(nth=1, count=1)),
    ("server.reshard", "thread_death", dict(nth=1, count=1)),
    ("server.reshard", "reset", dict(nth=2, count=1)),
    ("client.leave", "delay", dict(nth=1, count=1, delay_s=0.01)),
    ("client.leave", "reset", dict(nth=1, count=1)),
    ("client.leave", "error", dict(nth=1, count=1)),
    ("client.leave", "thread_death", dict(nth=1, count=1)),
]


@pytest.mark.parametrize("mode", sorted(SPECS))
@pytest.mark.parametrize(
    "site,kind,rule_kw", _ELASTIC_FAULTS,
    ids=[f"{s}-{k}-nth{kw.get('nth', 1)}" for s, k, kw in _ELASTIC_FAULTS])
def test_elastic_fault_matrix_exactly_once(mode, site, kind, rule_kw):
    """Faults at the reshard trigger, the barrier commit, or the LEAVE
    call itself: the epoch union stays exactly the uninterrupted stream
    (2 -> 1 has no wrap-pad) — a fault either delays the world change or
    aborts it cleanly as a typed error, never tears it half-applied."""
    spec = SPECS[mode](world=2)
    ref = np.concatenate([np.asarray(spec.rank_indices(0, r))
                          for r in range(2)])
    op = "leave" if site == "client.leave" else "reshard"
    plan = F.FaultPlan([F.FaultRule(site=site, kind=kind, **rule_kw)])
    delivered = {}
    aborted = []
    lock = threading.Lock()
    b_hit = threading.Barrier(2)
    b_go = threading.Barrier(2)
    with plan:
        with IndexServer(spec) as srv:

            def worker(r):
                got = []
                c = ServiceIndexClient(srv.address, rank=r, batch=31,
                                       backoff_base=0.01,
                                       reconnect_timeout=15.0)
                try:
                    it = c.epoch_batches(0)
                    for _ in range(1 + r):
                        got.append(next(it))
                    b_hit.wait(timeout=30.0)
                    if r == 0:
                        try:
                            if op == "leave":
                                c.leave(grace_ms=60_000)
                            else:
                                c.reshard(1)
                        except (F.InjectedFault, F.InjectedThreadDeath,
                                ConnectionError) as exc:
                            with lock:
                                aborted.append(exc)
                    b_go.wait(timeout=30.0)
                    for arr in it:
                        got.append(arr)
                finally:
                    with lock:
                        delivered[r] = got
                    c.close()

            threads = [threading.Thread(target=worker, args=(r,))
                       for r in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60.0)
                assert not t.is_alive(), "elastic chaos worker hung"
            generation = srv._state_dict()["generation"]
    assert plan.fired(site) > 0, "fault never fired; the test is vacuous"
    if aborted:
        # the LEAVE died client-side before reaching the daemon: the
        # world must be untouched and both ranks finish their epoch
        assert site == "client.leave"
        assert generation == 0
    else:
        assert generation == 1, "world change lost under injected fault"
    union = np.concatenate(
        [np.concatenate(v) if v else np.empty(0, np.int64)
         for v in delivered.values()])
    assert np.array_equal(np.sort(union), np.sort(ref)), (
        f"stream not exactly-once under {kind} at {site}")


# ---------------------------------------------------------- snapshot faults
def test_snapshot_disk_full_does_not_stop_serving(tmp_path):
    spec = plain_spec(world=1)
    ref = np.asarray(spec.rank_indices(0, 0))
    plan = F.FaultPlan([F.FaultRule(site="server.snapshot_write",
                                    kind="disk_full", count=0)])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with plan:
            with IndexServer(spec, snapshot_path=str(tmp_path / "s.json"),
                             snapshot_interval=1) as srv:
                with ServiceIndexClient(srv.address, rank=0,
                                        batch=37) as client:
                    got = client.epoch_indices(0)
    assert plan.fired("server.snapshot_write") >= 1
    assert np.array_equal(got, ref)
    assert srv.metrics.report()["counters"].get("snapshot_errors", 0) >= 1
    # warned exactly once, not once per failed write
    snap_warnings = [w for w in caught
                     if "snapshot write" in str(w.message)]
    assert len(snap_warnings) == 1


# ------------------------------------------- hot-standby replication faults
def _replicated_pair(spec, feed_timeout=0.25):
    standby = IndexServer(spec, role="standby",
                          repl_feed_timeout=feed_timeout)
    standby.start()
    primary = IndexServer(spec, standby=standby.address,
                          repl_feed_timeout=feed_timeout)
    primary.start()
    return primary, standby


def _wait_synced(primary, standby, timeout=10.0):
    t0 = time.monotonic()
    while not (primary._shipper is not None
               and primary._shipper.synced.is_set()
               and standby._applied_lsn >= primary._repl_log.lsn):
        if time.monotonic() - t0 > timeout:
            raise AssertionError("standby never caught up")
        time.sleep(0.01)


def test_repl_append_fault_never_touches_the_serving_path():
    """A WAL append that dies must cost the standby a re-SYNC, never the
    clients a byte: the stream stays bit-identical and the log heals."""
    spec = plain_spec(world=1)
    ref = np.asarray(spec.rank_indices(0, 0))
    plan = F.FaultPlan([F.FaultRule(site="repl.append", kind="error",
                                    nth=2, count=2)])
    with plan:
        primary, standby = _replicated_pair(spec)
        try:
            with ServiceIndexClient(primary.address, rank=0, batch=37,
                                    backoff_base=0.01) as client:
                got = client.epoch_indices(0)
            _wait_synced(primary, standby)
            assert standby._cursors.get(0, {}).get("epoch") == 0
        finally:
            primary.stop()
            standby.stop()
    assert plan.fired("repl.append") > 0, "fault never fired; vacuous"
    assert np.array_equal(got, ref), "stream diverged under repl.append"
    counters = primary.metrics.report()["counters"]
    assert counters.get("repl_append_errors", 0) >= 1
    assert counters.get("repl_resyncs", 0) >= 1


def test_repl_promote_fault_aborts_then_retry_succeeds():
    """The first promotion attempt dies BEFORE any state flips: the
    failing-over client just retries, the second attempt promotes, and
    the stream is still exactly-once."""
    spec = plain_spec(world=1)
    ref = np.asarray(spec.rank_indices(0, 0))
    plan = F.FaultPlan([F.FaultRule(site="repl.promote", kind="error",
                                    nth=1, count=1)])
    with plan:
        primary, standby = _replicated_pair(spec)
        client = ServiceIndexClient(primary.address, rank=0, batch=37,
                                    backoff_base=0.01,
                                    reconnect_timeout=2.0)
        try:
            it = client.epoch_batches(0)
            got = [next(it)]
            _wait_synced(primary, standby)
            primary.kill()
            got.extend(it)
        finally:
            client.close()
            primary.kill()
            standby.stop()
    assert plan.fired("repl.promote") > 0, "fault never fired; vacuous"
    assert standby.role == "primary", "retry after the aborted promotion"
    assert np.array_equal(np.concatenate(got), ref)
    counters = client.metrics.report()["counters"]
    assert counters.get("degraded_mode", 0) == 0


def test_zombie_write_refusal_survives_injected_fault():
    """The fencing refusal is load-bearing: even with a fault injected
    at the refusal site, the zombie's write is still refused with the
    typed ``fenced`` error carrying the new term, and its state never
    mutates."""
    spec = plain_spec(world=1)
    plan = F.FaultPlan([F.FaultRule(site="server.zombie_write",
                                    kind="error", count=0)])
    with plan:
        primary, standby = _replicated_pair(spec, feed_timeout=60.0)
        try:
            _wait_synced(primary, standby)
            epoch_before = primary.epoch
            assert standby._try_promote(force=True)
            sock = socket.create_connection(primary.address, timeout=5.0)
            try:
                P.send_msg(sock, P.MSG_HELLO,
                           {"proto": P.PROTOCOL_VERSION, "rank": 0,
                            "batch": 32, "term": standby.term})
                msg, header, _ = P.recv_msg(sock)
            finally:
                sock.close()
            assert msg == P.MSG_ERROR
            assert header["code"] == "fenced"
            assert header["term"] >= standby.term
            assert header["serving"] is False
            assert primary.epoch == epoch_before
        finally:
            primary.stop()
            standby.stop()
    assert plan.fired("server.zombie_write") > 0, "fault never fired"


# --------------------------------------------------- durability WAL faults
def _wal_records(wal_dir):
    w = WriteAheadLog(wal_dir, fsync="off")
    try:
        return w.read_records()
    finally:
        w.close(sync=False)


def test_wal_torn_append_degrades_never_the_stream(tmp_path):
    """A torn frame mid-append leaves a REAL torn tail on disk and
    degrades the WAL — the client's stream stays bit-identical, and the
    next restart cuts the tear and serves again."""
    spec = plain_spec(world=1)
    ref = np.asarray(spec.rank_indices(0, 0))
    wal_dir = str(tmp_path / "wal")
    plan = F.FaultPlan([F.FaultRule(site="wal.append", kind="torn_frame",
                                    nth=3, count=1)])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with plan:
            with IndexServer(spec, wal_dir=wal_dir) as srv:
                with ServiceIndexClient(srv.address, rank=0,
                                        batch=37) as client:
                    got = client.epoch_indices(0)
    assert plan.fired("wal.append") == 1, "fault never fired; vacuous"
    assert np.array_equal(got, ref), "stream diverged under wal.append"
    assert srv.metrics.report()["counters"].get("wal_append_errors", 0) >= 1
    assert any("torn frame" in str(w.message) for w in caught)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with IndexServer(plain_spec(world=1), wal_dir=wal_dir) as srv2:
            with ServiceIndexClient(srv2.address, rank=0,
                                    batch=37) as client:
                assert np.array_equal(client.epoch_indices(0), ref)
    assert srv2.metrics.report()["counters"].get("wal_torn_tails", 0) >= 1
    assert any("torn tail" in str(w.message) for w in caught)


def test_wal_fsync_fault_does_not_stop_serving(tmp_path):
    """Every fsync failing costs durability (counted), never a byte of
    the stream — and the records still reach the page cache, so a clean
    shutdown leaves a fully replayable log."""
    spec = plain_spec(world=1)
    ref = np.asarray(spec.rank_indices(0, 0))
    wal_dir = str(tmp_path / "wal")
    plan = F.FaultPlan([F.FaultRule(site="wal.fsync", kind="error",
                                    count=0)])
    with warnings.catch_warnings(), plan:
        warnings.simplefilter("ignore")
        with IndexServer(spec, wal_dir=wal_dir,
                         fsync="per_record") as srv:
            with ServiceIndexClient(srv.address, rank=0,
                                    batch=37) as client:
                got = client.epoch_indices(0)
    assert plan.fired("wal.fsync") >= 1, "fault never fired; vacuous"
    assert np.array_equal(got, ref), "stream diverged under wal.fsync"
    assert srv.metrics.report()["counters"].get("wal_fsync_errors", 0) >= 1
    recs = _wal_records(wal_dir)
    assert recs and [r["lsn"] for r in recs] == \
        list(range(1, len(recs) + 1))


def test_wal_rotate_disk_full_keeps_appending(tmp_path):
    """A failed segment rollover keeps appending to the full segment
    (bounded growth beats lost records); every record stays readable
    and later rollovers succeed."""
    from partiallyshuffledistributedsampler_tpu_torch.service.metrics import (
        ServiceMetrics,
    )
    m = ServiceMetrics()
    w = WriteAheadLog(str(tmp_path / "wal"), fsync="off",
                      segment_bytes=200, metrics=m)
    plan = F.FaultPlan([F.FaultRule(site="wal.rotate", kind="disk_full",
                                    nth=1, count=1)])
    with plan:
        for i in range(1, 31):
            assert w.append({"lsn": i, "op": "epoch", "epoch": i})
    assert plan.fired("wal.rotate") == 1, "fault never fired; vacuous"
    assert [r["lsn"] for r in w.read_records()] == list(range(1, 31))
    counters = m.report()["counters"]
    assert counters.get("wal_rotate_errors", 0) == 1
    assert counters.get("wal_rotations", 0) >= 1, "later rollovers healed"
    w.close()


def test_wal_gc_abort_between_seal_and_truncate(tmp_path):
    """A crash between the checkpoint seal and the segment truncation
    (injected at the GC's wal.rotate site) only delays reclamation:
    every record is still readable, and the next seal truncates."""
    w = WriteAheadLog(str(tmp_path / "wal"), fsync="off",
                      segment_bytes=200)
    for i in range(1, 61):
        w.append({"lsn": i, "op": "epoch", "epoch": i})
    w.register_owner("front")
    w.checkpoint("front", 30)
    nseg = len(w.segment_paths())
    plan = F.FaultPlan([F.FaultRule(site="wal.rotate", kind="error",
                                    nth=1, count=1)])
    with plan:  # armed ONLY around the seal: rollovers must not consume it
        assert w.checkpoint("front", 50) == 0
    assert plan.fired("wal.rotate") == 1, "fault never fired; vacuous"
    assert len(w.segment_paths()) == nseg, "aborted GC must not truncate"
    assert [r["lsn"] for r in w.read_records()] == list(range(1, 61))
    assert w.checkpoint("front", 55) > 0, "the next seal retries the GC"
    assert [r["lsn"] for r in w.read_records(after_lsn=50)] == \
        list(range(51, 61))
    w.close()


def test_wal_append_disk_full_recovery_stays_dense(tmp_path):
    """Two dropped appends (injected ENOSPC) leave holes that the next
    successful append noop-fills: the stream is untouched, the on-disk
    sequence stays dense, and a restarted daemon recovers and serves
    bit-identically."""
    spec = plain_spec(world=1)
    ref = np.asarray(spec.rank_indices(0, 0))
    wal_dir = str(tmp_path / "wal")
    plan = F.FaultPlan([F.FaultRule(site="wal.append", kind="disk_full",
                                    nth=2, count=2)])
    with plan:
        srv = IndexServer(spec, wal_dir=wal_dir)
        srv.start()
        with ServiceIndexClient(srv.address, rank=0, batch=37) as client:
            got = client.epoch_indices(0)
        srv.kill()
    assert plan.fired("wal.append") == 2, "fault never fired; vacuous"
    assert np.array_equal(got, ref), "stream diverged under wal.append"
    assert srv.metrics.report()["counters"].get("wal_append_errors", 0) == 2
    recs = _wal_records(wal_dir)
    assert [r["lsn"] for r in recs] == list(range(1, len(recs) + 1))
    assert [r["op"] for r in recs].count("noop") == 2
    srv2 = IndexServer(plain_spec(world=1), wal_dir=wal_dir)
    srv2.start()
    try:
        with ServiceIndexClient(srv2.address, rank=0, batch=37) as client:
            assert np.array_equal(client.epoch_indices(0), ref)
    finally:
        srv2.stop()
    assert srv2.metrics.report()["counters"].get("wal_recoveries", 0) == 1


# -------------------------------------------------- sampling fault matrix
def _weighted_spec(weights):
    from partiallyshuffledistributedsampler_tpu_torch.sampling import SamplingSpec
    return SamplingSpec.weighted((40, 30, 26), weights, epoch_samples=96,
                                 seed=7, window=8, backend=BACKEND)


def test_sampling_alias_build_fault_serves_uniform_loudly():
    """An injected alias-table build failure degrades to the UNIFORM
    table — loudly (RuntimeWarning), deterministically (the served
    stream equals the uniform-weights stream bit-for-bit), and on every
    surface (the fallback is computed inside the spec, so served
    batches and local regen degrade identically)."""
    spec = _weighted_spec((3, 1, 2))
    ref = _weighted_spec((1, 1, 1)).rank_indices(1, 0)
    plan = F.FaultPlan([F.FaultRule(site="sampling.alias_build",
                                    kind="error", count=0)])
    # same-thread check first: the fallback warns where it degrades
    with plan:
        with pytest.warns(RuntimeWarning, match="UNIFORM"):
            direct = spec.rank_indices(1, 0)
    assert np.array_equal(direct, ref)
    # then the served path: the server-side fallback serves the same
    # degraded-but-deterministic stream
    plan2 = F.FaultPlan([F.FaultRule(site="sampling.alias_build",
                                     kind="error", count=0)])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with plan2:
            with IndexServer(_weighted_spec((3, 1, 2))) as srv:
                with ServiceIndexClient(srv.address, rank=0, batch=37,
                                        backoff_base=0.01,
                                        reconnect_timeout=10.0) as client:
                    got = client.epoch_indices(1)
    assert plan.fired("sampling.alias_build") > 0, "vacuous"
    assert plan2.fired("sampling.alias_build") > 0, "vacuous"
    assert np.array_equal(got, ref), "served fallback diverged from uniform"


def test_sampling_dedup_check_fault_never_double_serves():
    """An injected seen-set membership failure is fail-safe: the check
    reports 'seen', the draw probes on, and the cross-epoch no-repeat
    law survives — a dedup fault may skip candidates, never re-serve
    one."""
    from partiallyshuffledistributedsampler_tpu_torch.sampling import SamplingSpec
    spec = SamplingSpec.deduped((40, 30, 26), epoch_samples=48, seed=7,
                                window=8, backend=BACKEND)
    plan = F.FaultPlan([F.FaultRule(site="sampling.dedup_check",
                                    kind="error", nth=5, count=3)])
    with plan:
        with IndexServer(spec) as srv:
            with ServiceIndexClient(srv.address, rank=0, batch=16,
                                    backoff_base=0.01,
                                    reconnect_timeout=10.0) as client:
                e0 = client.epoch_indices(0)
                e1 = client.epoch_indices(1)
    assert plan.fired("sampling.dedup_check") >= 1, "vacuous"
    assert len(e0) == 48 and len(e1) == 48, "epoch length moved"
    union = np.concatenate([e0, e1]).tolist()
    assert len(set(union)) == len(union), "dedup fault double-served an id"


# ------------------------------------------------- federation fault matrix
def test_cell_ship_torn_mid_record_never_double_applies(tmp_path):
    """A cross-cell shipping frame torn mid-record (``cell.ship``)
    forces the shipper through its reconnect + re-SYNC path; the
    receiving cell's overlap check must make the replay idempotent —
    the remote standby's folded state equals the home primary's
    exactly, nothing applied twice."""
    from partiallyshuffledistributedsampler_tpu_torch.federation import WalShipper

    spec = plain_spec(world=1)
    ref = np.asarray(spec.rank_indices(1, 0))
    primary = IndexServer(spec, wal_dir=str(tmp_path / "east"))
    remote = IndexServer(spec, role="standby", repl_feed_timeout=60.0,
                         wal_dir=str(tmp_path / "west"))
    plan = F.FaultPlan([F.FaultRule(site="cell.ship", kind="torn_frame",
                                    nth=2, count=1)])
    shipper = None
    try:
        remote.start()
        primary.start()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            with plan:
                shipper = WalShipper(
                    primary._repl_log, remote.address,
                    cell_id="east", target_cell="west",
                    state_fn=primary._repl_sync_state,
                    term_fn=lambda: primary.term,
                    on_fenced=lambda term: None,
                    metrics=primary.metrics)
                shipper.start()
                assert shipper.synced.wait(10.0)
                with ServiceIndexClient(primary.address, rank=0, batch=37,
                                        backoff_base=0.01,
                                        reconnect_timeout=10.0) as client:
                    got = client.epoch_indices(1)
                deadline = time.monotonic() + 10.0
                while shipper.shipped_lsn < primary._repl_log.lsn:
                    assert time.monotonic() < deadline, (
                        "shipper never drained after the torn frame")
                    time.sleep(0.01)
    finally:
        if shipper is not None:
            shipper.stop()
        primary.stop()
        remote.stop()
    assert plan.fired("cell.ship") > 0, "fault never fired; vacuous"
    assert np.array_equal(got, ref)
    # never double-applied: the remote fold IS the primary's state
    assert remote._cursors == primary._cursors
    assert remote.epoch == primary.epoch
    resyncs = primary.metrics.report()["counters"].get(
        "cell_ship_resyncs", 0)
    assert resyncs >= 1, "the torn frame never forced a re-SYNC"


def test_cell_fence_fault_leaves_exactly_one_writable_cell(tmp_path):
    """An injected ``cell.fence`` fault skips one server during the
    whole-cell fence at promotion.  The skipped server must self-fence
    at its first newer-term request (``_term_refusal``), so the end
    state is reached either way: exactly one writable cell."""
    from partiallyshuffledistributedsampler_tpu_torch.federation import Federation
    from partiallyshuffledistributedsampler_tpu_torch.service import protocol as P

    spec = plain_spec(world=2)
    plan = F.FaultPlan([F.FaultRule(site="cell.fence", kind="error",
                                    nth=1, count=1)])
    with Federation(spec, root=str(tmp_path), n_shards=2) as fed:
        fed.wait_synced()
        assert fed.wait_shipped()
        with plan:
            fed.promote("west")  # east alive: the fence IS the guard
        assert plan.fired("cell.fence") == 1, "fault never fired; vacuous"
        m = fed.metrics.report()["counters"]
        assert m.get("cell_fence_faults", 0) == 1
        assert m.get("cell_fenced", 0) == len(fed.cells["east"].servers()) - 1
        term = max(s.term for s in fed.cells["west"].mirrors)
        fenced = []
        for srv in fed.cells["east"].servers():
            # a post-promotion client carries the new term; the skipped
            # zombie fences itself on the spot, the rest were fenced
            sock = socket.create_connection(srv.address, timeout=5.0)
            try:
                P.send_msg(sock, P.MSG_HELLO,
                           {"proto": P.PROTOCOL_VERSION, "rank": 0,
                            "batch": 8, "term": term})
                msg, hdr, _ = P.recv_msg(sock)
            finally:
                sock.close()
            fenced.append((msg, hdr.get("code")))
        assert all(m_ == P.MSG_ERROR and c == "fenced"
                   for m_, c in fenced), fenced
        # exactly one writable cell remains: west serves
        with ServiceIndexClient(fed.cells["west"].address, rank=0,
                                batch=37, backoff_base=0.01,
                                reconnect_timeout=10.0) as client:
            got = client.epoch_indices(0)
    assert np.array_equal(got, np.asarray(spec.rank_indices(0, 0)))


def test_cell_migrate_fault_aborts_cleanly_and_retry_succeeds(tmp_path):
    """An injected ``cell.migrate`` fault during the cutover prepare
    phase aborts CLEANLY: the home cell unfreezes, nothing flipped,
    nothing fenced — and the retried migration succeeds with the
    established client's stream staying exactly-once end to end."""
    from partiallyshuffledistributedsampler_tpu_torch.federation import (
        Federation,
        MigrationAborted,
    )
    from partiallyshuffledistributedsampler_tpu_torch.tenancy import tenant_id_for

    spec = plain_spec(world=1)
    tenant = tenant_id_for(spec.fingerprint(include_world=False))
    ref = np.asarray(spec.rank_indices(0, 0))
    plan = F.FaultPlan([F.FaultRule(site="cell.migrate", kind="error",
                                    count=1)])
    with Federation(spec, root=str(tmp_path)) as fed:
        fed.wait_synced()
        with ServiceIndexClient(fed.address, rank=0, batch=23,
                                backoff_base=0.01,
                                reconnect_timeout=5.0) as client:
            it = client.epoch_batches(0)
            got = [next(it)]
            with plan:
                with pytest.raises(MigrationAborted):
                    fed.migrate_tenant(tenant, "west")
            assert plan.fired("cell.migrate") == 1, "vacuous"
            d = fed.directory()
            assert d.home(tenant) == "east", "abort must not flip"
            assert d.version == 1, "abort must not bump the directory"
            m = fed.metrics.report()["counters"]
            assert m.get("federation_migrate_aborts", 0) == 1
            assert m.get("cell_fenced", 0) == 0, "abort must not fence"
            got.append(next(it))  # unfrozen: the home cell still serves
            nd = fed.migrate_tenant(tenant, "west")  # the retry succeeds
            assert nd.home(tenant) == "west"
            for arr in it:
                got.append(arr)
    stream = np.concatenate(got)
    assert np.array_equal(stream, ref), (
        "abort + retry duplicated or skipped indices")
