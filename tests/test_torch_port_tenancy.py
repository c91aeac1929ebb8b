"""The port's counterpart of the JAX package's ``tests/test_tenancy.py``.

Every case runs on ``partiallyshuffledistributedsampler_tpu_torch`` with its
specs and loaders on ``backend="cpu"`` (no card), under the port's
lock-order sanitizer; the JAX file's text follows.

Multi-tenancy: one daemon, many jobs (docs/SERVICE.md "Tenancy").

A ``multi_tenant=True`` :class:`IndexServer` keys namespaces by the
world-stripped spec fingerprint: a HELLO carrying an unknown fingerprint
plus its wire spec *creates* the tenant; every later HELLO with that
fingerprint attaches to it.  Covered here:

* two tenants streaming concurrently are each bit-identical to a solo
  daemon run, in all three spec modes — tenancy must never leak into
  the served index streams;
* fair-share regen scheduling: a quiet tenant's job sorts ahead of a
  flooding tenant's backlog (the stride-scheduler starvation bound) and
  per-tenant concurrency caps skip, not head-block, the queue;
* admission control: the ``max_ranks`` quota refuses with the retryable
  ``tenant_admission`` code, the default tenant is not subject to
  another tenant's quota pressure, and a freed lease re-admits;
* the typed ``spec_mismatch`` refusal (single-tenant daemons and the
  ``max_tenants`` capacity limit alike) carrying BOTH fingerprints;
* chaos at the new ``tenant.admission`` fault site: the client retries
  through an injected admission fault and the stream stays exact;
* metrics isolation: per-client counters keyed by (tenant, client),
  per-tenant ``departed`` aggregates, and a tenant METRICS poll seeing
  only its own numbers; trace isolation for TRACE_DUMP;
* restart + failover: per-tenant snapshots rediscovered on restart, and
  a hard-killed multi-tenant primary failing over to a standby that
  restores EVERY tenant's cursors exactly-once.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from partiallyshuffledistributedsampler_tpu_torch import faults as F
from partiallyshuffledistributedsampler_tpu_torch import telemetry as T
from partiallyshuffledistributedsampler_tpu_torch.service import (
    FairShareScheduler,
    IndexServer,
    PartialShuffleSpec,
    ServiceError,
    ServiceIndexClient,
    SpecMismatchError,
    TenantQuota,
)
from partiallyshuffledistributedsampler_tpu_torch.tenancy import tenant_id_for

from test_torch_port_elastic_service import build_spec

from partiallyshuffledistributedsampler_tpu_torch.analysis import lockorder
from partiallyshuffledistributedsampler_tpu import (
    tenancy as JT,
)
from partiallyshuffledistributedsampler_tpu.utils.metrics import (
    MetricsRegistry as JMetricsRegistry,
)
from partiallyshuffledistributedsampler_tpu_torch.utils.metrics import (
    MetricsRegistry,
)

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

pytestmark = pytest.mark.tenancy


def plain_spec(world=1, n=512, window=64, seed=7):
    return PartialShuffleSpec.plain(n, window=window, world=world, seed=seed, backend=BACKEND)


def other_spec(world=2):
    """A second job whose world-stripped fingerprint differs from every
    ``build_spec``/``plain_spec`` default."""
    return PartialShuffleSpec.plain(433, window=32, world=world, seed=31, backend=BACKEND)


def wait_for(cond, timeout=10.0, interval=0.01):
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            raise AssertionError("condition not reached within deadline")
        time.sleep(interval)


def stream_all(address, spec, epoch=0, batch=37):
    """Concurrently stream every rank of ``spec`` through one daemon;
    returns ``{rank: ndarray}``."""
    out, errs = {}, []
    lock = threading.Lock()

    def worker(r):
        try:
            with ServiceIndexClient(address, rank=r, batch=batch,
                                    spec=spec) as c:
                arr = c.epoch_indices(epoch)
            with lock:
                out[r] = arr
        except BaseException as exc:  # surfaced by the caller
            with lock:
                errs.append(exc)

    threads = [threading.Thread(target=worker, args=(r,))
               for r in range(spec.world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
        assert not t.is_alive(), "stream worker hung"
    if errs:
        raise errs[0]
    return out


# ------------------------------------------------------------ bit-identity
@pytest.mark.parametrize("mode", ["plain", "mixture", "shard"])
def test_two_tenants_bit_identical_to_solo(mode):
    """Two jobs sharing one daemon each stream exactly what a dedicated
    daemon would serve them — concurrently, in every spec mode."""
    spec_a = build_spec(mode, 2)
    spec_b = other_spec(world=2)
    with IndexServer(spec_a, multi_tenant=True) as srv:
        results = {}
        errs = []

        def job(tag, spec):
            try:
                results[tag] = stream_all(srv.address, spec, epoch=0)
            except BaseException as exc:
                errs.append(exc)

        ta = threading.Thread(target=job, args=("a", spec_a))
        tb = threading.Thread(target=job, args=("b", spec_b))
        ta.start(), tb.start()
        ta.join(timeout=120.0), tb.join(timeout=120.0)
        assert not ta.is_alive() and not tb.is_alive()
        if errs:
            raise errs[0]
        assert set(srv.tenants()) == {
            tenant_id_for(spec_a.fingerprint(include_world=False)),
            tenant_id_for(spec_b.fingerprint(include_world=False)),
        }
    for tag, spec in (("a", spec_a), ("b", spec_b)):
        for r in range(2):
            ref = np.asarray(spec.rank_indices(0, r))
            assert np.array_equal(results[tag][r], ref), (
                f"tenant {tag} rank {r} diverged from solo ({mode})")


def test_tenant_attach_is_idempotent():
    """Re-HELLOs with a known fingerprint attach, never re-create."""
    spec_a, spec_b = plain_spec(world=1), other_spec(world=1)
    with IndexServer(spec_a, multi_tenant=True) as srv:
        for _ in range(3):
            # no eager __enter__ connect: the previous client's lease
            # release races its socket close, and only the RPC retry
            # layer re-HELLOs through a transient rank_taken
            c = ServiceIndexClient(srv.address, rank=0, spec=spec_b)
            try:
                c.epoch_indices(0)
            finally:
                c.close()
        counters = srv.metrics.report()["counters"]
        assert counters.get("tenants_created") == 1
        assert len(srv.tenants()) == 2


# ------------------------------------------------------------- fair share
def test_fair_share_quiet_tenant_not_starved():
    """The stride-scheduler bound: a quiet tenant's job enters at the
    global virtual clock and dispatches BEFORE the flooding tenant's
    queued backlog — it waits only for what is already running."""
    sched = FairShareScheduler(concurrency=1)
    order = []
    release = threading.Event()
    holding = threading.Event()

    def hold():
        with sched.slot("flood"):
            holding.set()
            release.wait(timeout=10.0)

    def job(tenant):
        with sched.slot(tenant):
            order.append(tenant)

    threads = [threading.Thread(target=hold)]
    threads[0].start()
    holding.wait(timeout=5.0)
    for _ in range(6):
        t = threading.Thread(target=job, args=("flood",))
        t.start()
        threads.append(t)
    wait_for(lambda: sched.stats()["queued"] == 6)
    quiet = threading.Thread(target=job, args=("quiet",))
    quiet.start()
    threads.append(quiet)
    wait_for(lambda: sched.stats()["queued"] == 7)
    release.set()
    for t in threads:
        t.join(timeout=10.0)
        assert not t.is_alive(), "scheduler worker hung"
    assert order.index("quiet") == 0, (
        f"quiet tenant starved behind the flood: {order}")


def test_fair_share_per_tenant_cap_skips_not_blocks():
    """A tenant at its ``regen_concurrency`` cap is skipped over; other
    tenants keep dispatching past its queued jobs."""
    sched = FairShareScheduler(concurrency=2)
    sched.set_quota("flood", concurrency=1)
    release = threading.Event()
    holding = threading.Event()
    got_quiet = threading.Event()
    flood_done = threading.Event()

    def hold():
        with sched.slot("flood"):
            holding.set()
            release.wait(timeout=10.0)

    def flood_job():
        with sched.slot("flood"):
            flood_done.set()

    def quiet_job():
        with sched.slot("quiet"):
            got_quiet.set()

    t1 = threading.Thread(target=hold)
    t1.start()
    holding.wait(timeout=5.0)
    t2 = threading.Thread(target=flood_job)
    t2.start()
    wait_for(lambda: sched.stats()["queued"] == 1)
    t3 = threading.Thread(target=quiet_job)
    t3.start()
    # the capped tenant's queued job must not head-block the quiet one
    assert got_quiet.wait(timeout=5.0), "cap head-blocked the queue"
    assert not flood_done.is_set(), "per-tenant cap was not enforced"
    release.set()
    assert flood_done.wait(timeout=5.0)
    for t in (t1, t2, t3):
        t.join(timeout=10.0)


def test_fair_share_wired_into_regen_path():
    """Server integration: with a shared concurrency-1 scheduler, both
    tenants' regens flow through the queue (the ``regen_queue_ms``
    histogram is observed) and both streams stay exact."""
    spec_a, spec_b = plain_spec(world=2), other_spec(world=2)
    sched = FairShareScheduler(concurrency=1)
    with IndexServer(spec_a, multi_tenant=True,
                     regen_scheduler=sched) as srv:
        got_a = stream_all(srv.address, spec_a)
        got_b = stream_all(srv.address, spec_b)
        hist = srv.metrics.report()["histograms"]
        assert hist.get("regen_queue_ms", {}).get("count", 0) >= 2
    for spec, got in ((spec_a, got_a), (spec_b, got_b)):
        for r in range(2):
            assert np.array_equal(got[r],
                                  np.asarray(spec.rank_indices(0, r)))
    assert sched.stats()["queued"] == 0 and sched.stats()["running"] == 0


# -------------------------------------------------------------- admission
def test_max_ranks_quota_refuses_then_readmits():
    spec_a, spec_b = plain_spec(world=2), other_spec(world=2)
    with IndexServer(spec_a, multi_tenant=True,
                     tenant_quota=TenantQuota(max_ranks=1)) as srv:
        c1 = ServiceIndexClient(srv.address, rank=0, spec=spec_b)
        c1._ensure_connected()
        try:
            c2 = ServiceIndexClient(srv.address, rank=1, spec=spec_b,
                                    backoff_base=0.02,
                                    reconnect_timeout=0.6)
            with pytest.raises(ServiceError) as ei:
                c2.epoch_indices(0)
            assert ei.value.code == "tenant_admission"
            assert "retry_ms" in ei.value.header
            assert c2.metrics.report()["counters"].get(
                "admission_waits", 0) >= 1
            c2.close()
            # another tenant's quota pressure never touches the default
            # tenant: both of ITS ranks still claim instantly
            got = stream_all(srv.address, spec_a)
            assert set(got) == {0, 1}
        finally:
            c1.close()
        # the freed lease re-admits (lease released with the connection)
        c3 = ServiceIndexClient(srv.address, rank=1, spec=spec_b,
                                backoff_base=0.02, reconnect_timeout=5.0)
        arr = c3.epoch_indices(0)
        assert np.array_equal(arr, np.asarray(spec_b.rank_indices(0, 1)))
        c3.close()
        counters = srv.metrics.report()["counters"]
        assert counters.get("tenant_admission_rejects", 0) >= 1


def test_spec_mismatch_is_typed_with_both_fingerprints():
    spec_a, spec_b = plain_spec(world=2), other_spec(world=2)
    with IndexServer(spec_a) as srv:  # single-tenant daemon
        c = ServiceIndexClient(srv.address, rank=0, spec=spec_b,
                               reconnect_timeout=1.0)
        with pytest.raises(SpecMismatchError) as ei:
            c._ensure_connected()
        c.close()
    err = ei.value
    assert err.code == "spec_mismatch"
    assert err.server_fingerprint == spec_a.fingerprint(include_world=False)
    assert err.client_fingerprint == spec_b.fingerprint(include_world=False)


def test_max_tenants_capacity_is_typed_spec_mismatch():
    spec_a, spec_b = plain_spec(world=1), other_spec(world=1)
    with IndexServer(spec_a, multi_tenant=True, max_tenants=1) as srv:
        c = ServiceIndexClient(srv.address, rank=0, spec=spec_b,
                               reconnect_timeout=1.0)
        with pytest.raises(SpecMismatchError) as ei:
            c._ensure_connected()
        c.close()
        assert ei.value.header.get("max_tenants") == 1
        assert srv.metrics.report()["counters"].get(
            "tenant_admission_rejects", 0) >= 1


# ------------------------------------------------------------------ chaos
def test_tenant_admission_chaos_stream_exact():
    """An injected fault at ``tenant.admission`` surfaces as retryable
    ``tenant_admission`` backpressure; the client rides it and the
    created tenant's stream is bit-identical."""
    spec_a, spec_b = plain_spec(world=1), other_spec(world=1)
    plan = F.FaultPlan([F.FaultRule(site="tenant.admission", kind="error",
                                    count=1)])
    with plan:
        with IndexServer(spec_a, multi_tenant=True) as srv:
            # no eager __enter__ connect: the retryable admission code is
            # handled by the RPC retry layer (like throttle/draining)
            c = ServiceIndexClient(srv.address, rank=0, spec=spec_b,
                                   backoff_base=0.01,
                                   reconnect_timeout=10.0)
            try:
                got = c.epoch_indices(0)
                assert c.metrics.report()["counters"].get(
                    "admission_waits", 0) >= 1
            finally:
                c.close()
    assert plan.fired("tenant.admission") > 0, \
        "fault never fired; the test is vacuous"
    assert np.array_equal(got, np.asarray(spec_b.rank_indices(0, 0)))


# ---------------------------------------------------------------- metrics
def test_metrics_keyed_by_tenant_and_isolated():
    """Per-client counters live in the owning tenant's table; a tenant
    METRICS poll sees only its own numbers; an evicted tenant client
    folds into ITS tenant's ``departed`` aggregate."""
    fake = {"now": 0.0}
    spec_a, spec_b = plain_spec(world=2), other_spec(world=2)
    tid_b = tenant_id_for(spec_b.fingerprint(include_world=False))
    with IndexServer(spec_a, multi_tenant=True, heartbeat_timeout=5.0,
                     clock=lambda: fake["now"]) as srv:
        with ServiceIndexClient(srv.address, rank=0, spec=spec_a) as ca:
            ca.epoch_indices(0)
        c1 = ServiceIndexClient(srv.address, rank=0, spec=spec_b)
        it = c1.epoch_batches(0)
        next(it)                      # per-client entry exists for (B, 0)
        fake["now"] += 10.0           # c1's lease goes stale
        c2 = ServiceIndexClient(srv.address, rank=0, spec=spec_b)
        c2._ensure_connected()        # claim evicts the stale lease
        rep = srv.metrics.report()
        # default tenant's table holds only its own clients
        assert "0" in rep["clients"]
        assert "tenants" in rep and tid_b in rep["tenants"]
        trep = rep["tenants"][tid_b]
        assert trep["tenant"] == tid_b
        # the evicted (B, 0) client folded into B's departed aggregate —
        # not the default tenant's
        assert trep.get("departed", {}).get("clients", 0) >= 1
        assert "departed" not in rep or rep["departed"].get(
            "clients", 0) == 0
        assert trep["counters"].get("evictions", 0) >= 1
        # a tenant's own METRICS poll is isolated: no cross-tenant rollup
        own = c2.server_metrics()
        assert own.get("tenant") == tid_b
        assert "tenants" not in own
        assert own["counters"].get("batches_served", 0) >= 1
        c1.close(), c2.close()


def test_trace_dump_isolated_per_tenant(tmp_path):
    T.reset()
    T.configure(enabled=True, dump_dir=str(tmp_path))
    try:
        spec_a, spec_b = plain_spec(world=1), other_spec(world=1)
        tid_a = tenant_id_for(spec_a.fingerprint(include_world=False))
        tid_b = tenant_id_for(spec_b.fingerprint(include_world=False))
        with IndexServer(spec_a, multi_tenant=True) as srv:
            with ServiceIndexClient(srv.address, rank=0, spec=spec_a) as ca:
                ca.epoch_indices(0)
                with ServiceIndexClient(srv.address, rank=0,
                                        spec=spec_b) as cb:
                    cb.epoch_indices(0)
                    dump_b = cb.trace_dump(limit=512)
                dump_a = ca.trace_dump(limit=512)
        tenants_a = {(e.get("attrs") or {}).get("tenant")
                     for e in dump_a["entries"]}
        tenants_b = {(e.get("attrs") or {}).get("tenant")
                     for e in dump_b["entries"]}
        assert tid_a in tenants_a, "dump missing own-tenant spans"
        assert tid_b not in tenants_a, "tenant B spans leaked into A's dump"
        assert tid_b in tenants_b
        assert tid_a not in tenants_b
    finally:
        T.reset()


# -------------------------------------------------------- restart/failover
def test_restart_rediscovers_tenant_snapshots(tmp_path):
    spec_a, spec_b = plain_spec(world=1), other_spec(world=1)
    tid_b = tenant_id_for(spec_b.fingerprint(include_world=False))
    snap = str(tmp_path / "snap.json")
    with IndexServer(spec_a, multi_tenant=True, snapshot_path=snap,
                     snapshot_interval=1) as srv:
        with ServiceIndexClient(srv.address, rank=0, spec=spec_b) as c:
            c.set_epoch(3)
            c.epoch_indices(3)
    with IndexServer(spec_a, multi_tenant=True, snapshot_path=snap) as srv2:
        assert tid_b in srv2.tenants()
        with ServiceIndexClient(srv2.address, rank=0, spec=spec_b) as c:
            assert c.server_epoch == 3
            got = c.epoch_indices(3)
    assert np.array_equal(got, np.asarray(spec_b.rank_indices(3, 0)))


def test_multi_tenant_failover_restores_every_tenant():
    """Hard-kill the primary while BOTH tenants are mid-epoch: every
    stream finishes on the promoted standby bit-identical to an unkilled
    run — the replicated tenant map and per-(tenant, rank) cursors make
    the failover exactly-once for all namespaces at once."""
    spec_a, spec_b = plain_spec(world=1, n=700), other_spec(world=1)
    standby = IndexServer(spec_a, role="standby", repl_feed_timeout=0.25,
                          multi_tenant=True)
    standby.start()
    primary = IndexServer(spec_a, standby=standby.address,
                          repl_feed_timeout=0.25, multi_tenant=True)
    primary.start()
    delivered, errs = {}, []
    lock = threading.Lock()
    b_streamed = threading.Barrier(3)
    b_killed = threading.Barrier(3)

    def worker(tag, spec):
        got = []
        c = ServiceIndexClient(primary.address, rank=0, batch=23, spec=spec,
                               backoff_base=0.01, reconnect_timeout=2.0)
        try:
            it = c.epoch_batches(0)
            got.append(next(it))
            b_streamed.wait(timeout=30.0)
            b_killed.wait(timeout=30.0)
            for arr in it:
                got.append(arr)
        except BaseException as exc:
            errs.append(exc)
        finally:
            with lock:
                delivered[tag] = (got, c.metrics.report()["counters"])
            c.close()

    threads = [threading.Thread(target=worker, args=("a", spec_a)),
               threading.Thread(target=worker, args=("b", spec_b))]
    try:
        for t in threads:
            t.start()
        b_streamed.wait(timeout=30.0)
        wait_for(lambda: (primary._shipper is not None
                          and primary._shipper.synced.is_set()
                          and standby._applied_lsn >= primary._repl_log.lsn))
        primary.kill()
        b_killed.wait(timeout=30.0)
        for t in threads:
            t.join(timeout=60.0)
            assert not t.is_alive(), "failover worker hung"
    finally:
        primary.kill()
        standby.stop()
    if errs:
        raise errs[0]
    assert standby.role == "primary", "standby never promoted"
    for tag, spec in (("a", spec_a), ("b", spec_b)):
        got, counters = delivered[tag]
        ref = np.asarray(spec.rank_indices(0, 0))
        assert np.array_equal(np.concatenate(got), ref), (
            f"tenant {tag} stream diverged across the failover")
        assert counters.get("failovers", 0) >= 1
        assert counters.get("degraded_mode", 0) == 0


# ------------------------------------------------- across the two packages


def _dispatch_order(Scheduler, Registry, jobs, *, concurrency):
    """Queue ``jobs`` (tenant, cost) one by one behind a held slot, then
    release it: the order the scheduler dispatches them in, and the queue
    waits it recorded against a scripted clock (each reading 1 ms past
    the last)."""
    reg = Registry()
    sched = Scheduler(concurrency=concurrency, metrics=reg)
    sched.set_quota("heavy", weight=3.0)
    sched.set_quota("capped", concurrency=1)
    ticks = iter(range(10_000))
    tick_lock = threading.Lock()

    def clock():
        with tick_lock:
            return next(ticks) / 1000.0

    order, release, holding = [], threading.Event(), threading.Event()
    order_lock = threading.Lock()

    def hold():
        with sched.slot("holder"):
            holding.set()
            release.wait(timeout=10.0)

    def job(tenant, cost):
        with sched.slot(tenant, cost=cost, clock=clock):
            with order_lock:
                order.append(tenant)

    holders = [threading.Thread(target=hold) for _ in range(concurrency)]
    for t in holders:
        t.start()
    holding.wait(timeout=5.0)
    wait_for(lambda: sched.stats()["running"] == concurrency)
    threads = []
    for i, (tenant, cost) in enumerate(jobs):
        t = threading.Thread(target=job, args=(tenant, cost))
        t.start()
        threads.append(t)
        wait_for(lambda: sched.stats()["queued"] == i + 1)
    release.set()
    for t in holders + threads:
        t.join(timeout=10.0)
        assert not t.is_alive(), "scheduler worker hung"
    return (order, sched.stats(), sched.dispatched,
            reg.histogram("regen_queue_ms").snapshot())


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fair_share_dispatch_order_equals_the_jax_scheduler(seed):
    """The same jobs (tenants of weight 1 and 3, a capped tenant, costs
    from a numpy seed) queued the same way behind one slot dispatch in the
    same order in both packages' schedulers, with the same queue waits on
    a scripted clock."""
    concurrency = 1  # serial: the dispatch order is the append order
    rng = np.random.default_rng(seed)
    tenants = ["light", "heavy", "capped", "quiet"]
    jobs = [(tenants[int(rng.integers(0, 3))], float(rng.integers(1, 5)))
            for _ in range(16)] + [("quiet", 1.0)]
    j = _dispatch_order(JT.FairShareScheduler, JMetricsRegistry, jobs,
                        concurrency=concurrency)
    p = _dispatch_order(FairShareScheduler, MetricsRegistry, jobs,
                        concurrency=concurrency)
    assert j == p
    assert sorted(p[0]) == sorted(t for t, _ in jobs)
    # the quiet tenant's job enters at the global virtual clock, ahead of
    # the other tenants' backlog
    assert p[0].index("quiet") < len(jobs) - 1


def test_tenant_ids_and_quotas_equal_the_jax_packages():
    for kind in ("plain", "mixture", "shard"):
        for world in (1, 4):
            spec = build_spec(kind, world)
            wire = spec.to_wire()
            from partiallyshuffledistributedsampler_tpu.service import (
                PartialShuffleSpec as JSpec,
            )

            jspec = JSpec.from_wire(wire)
            fp = spec.fingerprint(include_world=False)
            assert fp == jspec.fingerprint(include_world=False)
            assert tenant_id_for(fp) == JT.tenant_id_for(fp)
    for kw in ({}, {"max_ranks": 2, "max_inflight": 4,
                    "regen_concurrency": 1}):
        assert vars(TenantQuota(**kw)) == vars(JT.TenantQuota(**kw))
