"""The port's counterpart of the JAX package's ``tests/test_capability.py``.

Every case runs on ``partiallyshuffledistributedsampler_tpu_torch`` with its
specs and loaders on ``backend="cpu"`` (no card), under the port's
lock-order sanitizer; the JAX file's text follows.

Signed epoch capabilities: serve seeds, not indices (docs/CAPABILITY.md).

The contract under test: a client holding the deployment secret fetches
ONE signed grant per epoch and regenerates its index stream on-device,
bit-identical to what the served-batch path would have shipped — in all
three spec modes, across a mid-epoch reshard (the grant's generation is
revoked and the typed ``capability_stale`` refusal carries the fresh
one), and across a primary kill + standby promotion (issued-capability
records ride the replication log).  Every verification failure is a
LOUD :class:`CapabilityError` (never a silently-different stream), and
the loader's fallback ladder drops capability → served batches →
degraded local regen.  A daemon without a secret puts zero capability
bytes on the wire.

These run inside tier-1 and are the first leg of the
``make capability-smoke`` gate (``-m capability``).
"""

from __future__ import annotations

import threading
import time
import warnings

import numpy as np
import pytest

from partiallyshuffledistributedsampler_tpu_torch import faults as F
from partiallyshuffledistributedsampler_tpu_torch.capability import (
    CapabilityError,
    EpochCapability,
    membership_stream,
    replay_trail,
)
from partiallyshuffledistributedsampler_tpu_torch.sampler.host_loader import (
    HostDataLoader,
)
from partiallyshuffledistributedsampler_tpu_torch.service import (
    IndexServer,
    PartialShuffleSpec,
    ServiceError,
    ServiceIndexClient,
)

from test_torch_port_elastic_service import (
    MAX_UNIT,
    assert_union_law,
    build_spec,
    epoch_union_ref,
)

from partiallyshuffledistributedsampler_tpu_torch.analysis import lockorder
from partiallyshuffledistributedsampler_tpu import (
    capability as JC,
)
from partiallyshuffledistributedsampler_tpu import (
    service as JS,
)
from partiallyshuffledistributedsampler_tpu.ops.mixture import (
    MixtureSpec as JMixtureSpec,
)
from partiallyshuffledistributedsampler_tpu_torch.ops.mixture import (
    MixtureSpec,
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

pytestmark = pytest.mark.capability

SECRET = b"psds-test-deployment-secret"


def cap_client(address, rank, spec, *, batch=37, secret=SECRET, **kw):
    kw.setdefault("backoff_base", 0.01)
    kw.setdefault("reconnect_timeout", 20.0)
    return ServiceIndexClient(address, rank=rank, batch=batch, spec=spec,
                              capability_secret=secret, **kw)


# The JAX file's token and membership-stream cases have their counterparts
# in test_torch_port_capability.py; the served ones follow.


# -------------------------------------------------- the shared regen helper
def test_two_layer_cascade_local_regen_bit_identity():
    """A client riding TWO mid-epoch world changes (4 -> 3 -> 2) must
    recompose its exact delivered stream locally: the membership trail
    replay in ``capability/regen.py`` is the one source of truth for
    both the degraded fallback and capability-mode regen."""
    spec = build_spec("plain", 4)
    ref = epoch_union_ref(spec)
    delivered = {}
    clients = {}
    errors = []
    lock = threading.Lock()
    # park/release pairs: everyone parks at bN, rank 0 issues the reshard
    # while the other ranks are still parked (the RESHARD handler freezes
    # the barrier synchronously, before its reply), then bNr releases the
    # pullers — so no rank can race through its remaining allocation at
    # the old generation before the freeze exists server-side
    b1, b1r = threading.Barrier(4), threading.Barrier(4)
    b2, b2r = threading.Barrier(4), threading.Barrier(4)

    with IndexServer(spec) as srv:
        addr = srv.address

        def worker(r):
            got = []
            c = ServiceIndexClient(addr, rank=r, batch=23,
                                   backoff_base=0.01,
                                   reconnect_timeout=20.0)
            clients[r] = c
            try:
                it = c.epoch_batches(0)
                got.append(next(it))
                got.append(next(it))
                b1.wait(timeout=30.0)
                if r == 0:
                    c.reshard(3)
                b1r.wait(timeout=30.0)
                ended = False
                try:
                    # pull until the first commit is adopted (the
                    # shrunk-out rank 3 ends here instead)
                    while c.generation < 1:
                        got.append(next(it))
                except StopIteration:
                    ended = True
                b2.wait(timeout=30.0)
                if r == 0:
                    c.reshard(2)
                b2r.wait(timeout=30.0)
                if not ended:
                    try:
                        while c.generation < 2:
                            got.append(next(it))
                        for arr in it:
                            got.append(arr)
                    except StopIteration:
                        pass
            except BaseException as exc:
                errors.append((r, exc))
            finally:
                with lock:
                    delivered[r] = got

        threads = [threading.Thread(target=worker, args=(r,))
                   for r in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
            assert not t.is_alive(), "cascade worker hung"
        assert not errors, errors
        try:
            c0 = clients[0]
            assert c0.generation == 2
            assert len(c0.layers) == 2
            local0 = c0.local_epoch_indices(spec, 0)
            assert np.array_equal(np.concatenate(delivered[0]), local0), (
                "two-layer trail replay diverged from the live stream")
        finally:
            for c in clients.values():
                c.close()
    union = np.concatenate([np.concatenate(v)
                            for v in delivered.values() if v])
    assert_union_law(union, ref, new_world=3, max_unit=1, reshards=2)


# --------------------------------------------- capability-vs-served streams
@pytest.mark.parametrize("mode", ["plain", "mixture", "shard"])
def test_capability_stream_bit_identical_to_served(mode):
    """Zero index bytes on the wire, same indices on the device: the
    capability path must bit-match the served-batch path (itself pinned
    to the spec kernel) in every spec mode, across epochs."""
    spec = build_spec(mode, 2)
    with IndexServer(spec, capability_secret=SECRET) as srv:
        cap_c = cap_client(srv.address, 0, spec)
        served_c = ServiceIndexClient(srv.address, rank=1, batch=37)
        try:
            for epoch in (0, 1):
                got = cap_c.capability_epoch_indices(epoch)
                assert np.array_equal(got, np.asarray(
                    spec.rank_indices(epoch, 0))), (mode, epoch)
                assert np.array_equal(served_c.epoch_indices(epoch),
                                      np.asarray(
                                          spec.rank_indices(epoch, 1)))
            counters = srv.metrics.report()["counters"]
            assert counters.get("capabilities_issued", 0) >= 2
            assert counters.get("capability_rejects", 0) == 0
        finally:
            cap_c.close()
            served_c.close()


def test_capability_off_zero_protocol_overhead():
    """A secretless daemon serving secretless clients never sees a
    capability frame, counter, or reply field — the feature is
    byte-invisible until both sides opt in."""
    spec = build_spec("plain", 1)
    with IndexServer(spec) as srv:
        c = ServiceIndexClient(srv.address, rank=0, batch=64)
        try:
            got = c.epoch_indices(0)
            assert np.array_equal(got, np.asarray(spec.rank_indices(0, 0)))
            c.heartbeat()
            assert c._cap_drain is None, (
                "served-batch heartbeat replies must not carry cap_drain")
            counters = srv.metrics.report()["counters"]
            assert not any(k.startswith("capab") for k in counters), counters
        finally:
            c.close()


# ----------------------------------------------------------- loud refusals
def test_secretless_daemon_refuses_and_loader_falls_back_to_served():
    spec = PartialShuffleSpec.plain(997, window=64, seed=7, world=1, backend=BACKEND)
    X = np.arange(997, dtype=np.int64)
    ref = HostDataLoader(X, window=64, batch=64, seed=7, rank=0, world=1, index_backend=BACKEND, device="cpu")
    with IndexServer(spec) as srv:
        c = cap_client(srv.address, 0, spec, batch=64)
        try:
            with pytest.raises(CapabilityError,
                               match="no capability_secret"):
                c.capability_epoch_indices(0)
            loader = HostDataLoader(X, window=64, batch=64, seed=7, rank=0,
                                    world=1, index_client=c,
                                    capability_mode=True, index_backend=BACKEND, device="cpu")
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                got = loader.epoch_indices(0)
            assert np.array_equal(got, ref.epoch_indices(0))
            assert loader.degraded is False
            counters = c.metrics.report()["counters"]
            assert counters.get("capability_fallbacks", 0) >= 1
        finally:
            c.close()


def test_wrong_secret_is_refused_loudly():
    spec = build_spec("plain", 1)
    with IndexServer(spec, capability_secret=b"the-real-key") as srv:
        c = cap_client(srv.address, 0, spec, batch=64,
                       secret=b"an-impostor-key")
        try:
            with pytest.raises(CapabilityError, match="HMAC"):
                c.capability_epoch_indices(0)
            assert c.metrics.report()["counters"].get(
                "capability_rejects", 0) >= 1
        finally:
            c.close()


def test_multi_tenant_capability_isolation():
    """One daemon, two jobs: each tenant's capability path bit-matches
    its own spec, and tenant A's grant is refused by tenant B — both on
    the fingerprint and on the tenant binding."""
    spec_a = PartialShuffleSpec.plain(512, window=64, world=1, seed=7, backend=BACKEND)
    spec_b = PartialShuffleSpec.plain(433, window=32, world=1, seed=31, backend=BACKEND)
    with IndexServer(spec_a, multi_tenant=True,
                     capability_secret=SECRET) as srv:
        ca = cap_client(srv.address, 0, spec_a, batch=64)
        cb = cap_client(srv.address, 0, spec_b, batch=64)
        try:
            assert np.array_equal(ca.capability_epoch_indices(0),
                                  np.asarray(spec_a.rank_indices(0, 0)))
            assert np.array_equal(cb.capability_epoch_indices(0),
                                  np.asarray(spec_b.rank_indices(0, 0)))
            assert ca.tenant != cb.tenant
            grant_a = ca._fetch_capability(1, spec_a)
            # wrong job: the fingerprint in the grant is not B's spec
            with pytest.raises(CapabilityError, match="fingerprint"):
                cb._verify_capability(grant_a, 1, spec_b)
            # right fingerprint, wrong namespace: the tenant binding
            # still refuses (a stolen grant must not cross tenants)
            with pytest.raises(CapabilityError, match="tenant"):
                cb._verify_capability(grant_a, 1, spec_a)
            assert cb.metrics.report()["counters"].get(
                "capability_rejects", 0) >= 2
        finally:
            ca.close()
            cb.close()


# -------------------------------------------------- the batchless heartbeat
def test_idle_heartbeat_cadence_with_injected_clock():
    """A capability stream puts no GET_BATCH on the wire, so the
    keepalive cadence is the ONLY thing holding the lease and feeding
    the drain gate.  With an injected clock: a frozen clock flushes only
    the terminal ack; an advancing clock flushes at least every
    ``capability_heartbeat_s`` of clock time."""
    spec = build_spec("plain", 1)

    class FakeClock:
        def __init__(self, step):
            self.t, self.step = 0.0, step

        def __call__(self):
            self.t += self.step
            return self.t

    def count_heartbeats(step):
        # a wide server window keeps the slack law from ever forcing a
        # flush: every mid-stream heartbeat here is cadence-driven
        with IndexServer(spec, capability_secret=SECRET,
                         max_inflight=64) as srv:
            c = cap_client(srv.address, 0, spec, batch=37,
                           capability_heartbeat_s=1.0,
                           clock=FakeClock(step))
            calls = []
            real_hb = c.heartbeat

            def counting_hb():
                calls.append(1)
                return real_hb()

            c.heartbeat = counting_hb
            try:
                got = c.capability_epoch_indices(0)
                assert np.array_equal(
                    got, np.asarray(spec.rank_indices(0, 0)))
            finally:
                c.close()
            return len(calls)

    assert count_heartbeats(0.0) == 1      # terminal ack only
    # 997/37 = 27 batches; >= 1 clock tick per batch at 0.2 each means
    # a flush at least every 5 batches on a 1.0 cadence
    assert count_heartbeats(0.2) >= 4


# ------------------------------------------------------------------- chaos
def test_chaos_corrupt_capability_refused_and_loader_falls_back():
    """An injected signature corruption at ``capability.verify`` is a
    loud refusal at the client, and one rung down the ladder at the
    loader: the stream arrives bit-exact over served batches."""
    spec = PartialShuffleSpec.plain(530, window=32, seed=7, world=1, backend=BACKEND)
    X = np.arange(530, dtype=np.int64)
    with F.FaultPlan([F.FaultRule(site="capability.verify",
                                  kind="corrupt")]) as plan:
        with IndexServer(spec, capability_secret=SECRET) as srv:
            c = cap_client(srv.address, 0, spec, batch=64)
            try:
                loader = HostDataLoader(X, window=32, batch=64, seed=7,
                                        rank=0, world=1, index_client=c,
                                        capability_mode=True, index_backend=BACKEND, device="cpu")
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", RuntimeWarning)
                    got = loader.epoch_indices(0)
                assert np.array_equal(
                    got, np.asarray(spec.rank_indices(0, 0)))
                counters = c.metrics.report()["counters"]
                assert counters.get("capability_rejects", 0) >= 1
                assert counters.get("capability_fallbacks", 0) >= 1
            finally:
                c.close()
    assert plan.fired("capability.verify")


def test_chaos_issue_delay_stream_stays_exact():
    spec = build_spec("plain", 1)
    with F.FaultPlan([F.FaultRule(site="capability.issue", kind="delay",
                                  delay_s=0.05)]) as plan:
        with IndexServer(spec, capability_secret=SECRET) as srv:
            c = cap_client(srv.address, 0, spec, batch=64)
            try:
                got = c.capability_epoch_indices(0)
                assert np.array_equal(
                    got, np.asarray(spec.rank_indices(0, 0)))
                hists = srv.metrics.report()["histograms"]
                assert "capability_issue_ms" in hists
            finally:
                c.close()
    assert plan.fired("capability.issue")


def test_chaos_issue_fault_is_typed_and_retried():
    """A fault inside issuance surfaces as the retryable
    ``capability_issue`` code; the client retries through it and the
    stream stays exact."""
    spec = build_spec("plain", 1)
    with F.FaultPlan([F.FaultRule(site="capability.issue",
                                  kind="error")]) as plan:
        with IndexServer(spec, capability_secret=SECRET) as srv:
            c = cap_client(srv.address, 0, spec, batch=64)
            try:
                got = c.capability_epoch_indices(0)
                assert np.array_equal(
                    got, np.asarray(spec.rank_indices(0, 0)))
                counters = srv.metrics.report()["counters"]
                assert counters.get("capability_rejects", 0) >= 1
                assert counters.get("capabilities_issued", 0) >= 1
            finally:
                c.close()
    assert plan.fired("capability.issue")


# ------------------------------------------------------- lifecycle: reshard
@pytest.mark.parametrize("mode", ["plain", "mixture", "shard"])
def test_capability_rides_mid_epoch_reshard_union_law(mode):
    """The reshard revokes every outstanding grant: riding clients
    drain to the frozen watermark on ``cap_drain`` notices, re-fetch
    through ``capability_stale``, and finish on the new membership —
    union law across 2 -> 3 with a late joiner."""
    spec = build_spec(mode, 2)
    ref = epoch_union_ref(spec)
    delivered = {}
    lock = threading.Lock()
    errors = []
    b_hit = threading.Barrier(2)
    go_join = threading.Event()

    with IndexServer(spec, capability_secret=SECRET) as srv:
        addr = srv.address

        def worker(r):
            got = []
            c = cap_client(addr, r, spec, capability_heartbeat_s=0.03)
            try:
                it = c.capability_epoch_batches(0)
                for _ in range(4 + r):
                    try:
                        got.append(next(it))
                    except StopIteration:
                        break
                b_hit.wait(timeout=30.0)
                if r == 0:
                    c.reshard(3)
                    go_join.set()
                for arr in it:
                    got.append(arr)
                    time.sleep(0.003)
            except BaseException as exc:  # surfaced by the main thread
                errors.append(exc)
            finally:
                with lock:
                    delivered[r] = got
                c.close()

        def joiner():
            deadline = time.monotonic() + 20.0
            go_join.wait(timeout=30.0)
            while True:
                c = cap_client(addr, None, spec,
                               capability_heartbeat_s=0.03)
                try:
                    got = c.capability_epoch_indices(0)
                    with lock:
                        delivered["joiner"] = [got]
                    return
                except ServiceError as exc:
                    if exc.code not in ("no_rank", "rank_taken") \
                            or time.monotonic() > deadline:
                        errors.append(exc)
                        return
                    time.sleep(0.05)
                except BaseException as exc:
                    errors.append(exc)
                    return
                finally:
                    c.close()

        threads = [threading.Thread(target=worker, args=(r,))
                   for r in range(2)]
        threads.append(threading.Thread(target=joiner))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
            assert not t.is_alive(), "capability reshard worker hung"
        assert not errors, errors
        counters = srv.metrics.report()["counters"]
    union = np.concatenate([np.concatenate(v) for v in delivered.values()
                            if v])
    assert_union_law(union, ref, new_world=3, max_unit=MAX_UNIT[mode])
    assert counters.get("capabilities_issued", 0) >= 3
    assert counters.get("capability_stale", 0) >= 1
    assert counters.get("reshards", 0) == 1


# ------------------------------------------------------ lifecycle: failover
def test_capability_survives_primary_kill_and_promotion():
    """Issued-capability records ride the replication log: a promoted
    standby knows the outstanding grant, keeps honoring its acks, and
    the regenerated stream crosses the failover bit-identically."""
    spec = build_spec("plain", 1)
    standby = IndexServer(spec, role="standby", repl_feed_timeout=0.25,
                          capability_secret=SECRET)
    standby.start()
    primary = IndexServer(spec, standby=standby.address,
                          repl_feed_timeout=0.25,
                          capability_secret=SECRET)
    primary.start()
    c = cap_client(primary.address, 0, spec,
                   capability_heartbeat_s=0.05, reconnect_timeout=5.0)
    try:
        it = c.capability_epoch_batches(0)
        got = [next(it) for _ in range(3)]
        deadline = time.monotonic() + 10.0
        while not (primary._shipper is not None
                   and primary._shipper.synced.is_set()
                   and standby._applied_lsn >= primary._repl_log.lsn):
            assert time.monotonic() < deadline, "standby never synced"
            time.sleep(0.01)
        # the record crossed BEFORE the kill: this is what lets the
        # standby honor (and re-issue) the grant after promotion
        assert 0 in standby._cap_records
        assert standby._cap_records[0]["epoch"] == 0
        primary.kill()
        got.extend(it)
        assert np.array_equal(np.concatenate(got),
                              np.asarray(spec.rank_indices(0, 0)))
        assert standby.role == "primary", "standby never promoted"
        counters = c.metrics.report()["counters"]
        assert counters.get("failovers", 0) >= 1
        assert counters.get("degraded_mode", 0) == 0
        # the next epoch's grant comes from the promoted standby
        assert np.array_equal(c.capability_epoch_indices(1),
                              np.asarray(spec.rank_indices(1, 0)))
    finally:
        c.close()
        primary.kill()
        standby.stop()


# ------------------------------------------------- across the two packages


def _spec_pair(mode):
    if mode == "plain":
        return (JS.PartialShuffleSpec.plain(997, window=64, seed=7, world=2),
                PartialShuffleSpec.plain(997, window=64, seed=7, world=2,
                                         backend=BACKEND))
    args = ([400, 300, 200], [5, 3, 2])
    return (JS.PartialShuffleSpec.mixture(JMixtureSpec(*args, windows=32),
                                          seed=7, world=2,
                                          epoch_samples=600),
            PartialShuffleSpec.mixture(MixtureSpec(*args, windows=32),
                                       seed=7, world=2, epoch_samples=600,
                                       backend=BACKEND))


@pytest.mark.parametrize("mode", ["plain", "mixture"])
@pytest.mark.parametrize("server", ["port", "jax"])
def test_a_grant_verifies_in_the_other_packages_client(mode, server):
    """A grant issued by one package's daemon verifies in the other
    package's client, whose regen of the stream is the spec's; the grant's
    wire verifies in both packages' tokens."""
    j_spec, p_spec = _spec_pair(mode)
    S, srv_spec, C, cli_spec = (
        (IndexServer, p_spec, JS.ServiceIndexClient, j_spec)
        if server == "port"
        else (JS.IndexServer, j_spec, ServiceIndexClient, p_spec))
    with S(srv_spec, capability_secret=SECRET) as srv:
        with C(srv.address, rank=1, batch=37, spec=cli_spec,
               capability_secret=SECRET, backoff_base=0.01,
               reconnect_timeout=20.0) as c:
            got = c.capability_epoch_indices(2)
            wire = c._fetch_capability(3, cli_spec).to_wire()
        counters = srv.metrics.report()["counters"]
    assert np.array_equal(got, np.asarray(j_spec.rank_indices(2, 1)))
    assert counters.get("capabilities_issued", 0) >= 2
    assert counters.get("capability_rejects", 0) == 0
    for Token in (EpochCapability, JC.EpochCapability):
        cap = Token.from_wire(wire)
        assert cap.verify(SECRET) and not cap.verify(b"another-secret")
        assert cap.epoch == 3 and cap.world == 2
