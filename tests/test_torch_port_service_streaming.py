"""The port's counterpart of the JAX package's ``tests/test_streaming.py``:
its served cases (the spec laws and the loader's streaming units are held
in test_torch_port_spec.py and test_torch_port_host_loader.py).

Every case runs on ``partiallyshuffledistributedsampler_tpu_torch`` with its
specs and loaders on ``backend="cpu"`` (no card), under the port's
lock-order sanitizer; the JAX file's text follows.

Epochless moving-horizon streaming (docs/STREAMING.md).

The contract under test: the index space is append-only and the shuffle
never sees an "epoch end" — the stream is cut into horizons of H
samples, horizon generation ``g`` IS epoch ``g`` everywhere in the
framework, a horizon advance is an ack-gated lightweight barrier (not a
reshard), and the exactly-once law extends to the unbounded stream:
appends landing mid-serve, injected append/advance faults, a mid-stream
elastic reshard and a primary kill at the advance barrier must all
leave the union of every rank's delivered indices equal to the eligible
samples, each exactly once — while server + WAL state stays O(horizon),
not O(stream).

These run inside tier-1 and are the first leg of the
``make streaming-smoke`` gate (``-m streaming``).
"""

from __future__ import annotations

import json
import threading
import time
from collections import Counter

import numpy as np
import pytest

from partiallyshuffledistributedsampler_tpu_torch import faults as F
from partiallyshuffledistributedsampler_tpu_torch.durability.recover import (
    recover_unstarted,
)
from partiallyshuffledistributedsampler_tpu_torch.ops.mixture import MixtureSpec
from partiallyshuffledistributedsampler_tpu_torch.sampler.host_loader import (
    HostDataLoader,
)
from partiallyshuffledistributedsampler_tpu_torch.service import (
    IndexServer,
    ServiceError,
    ServiceIndexClient,
)
from partiallyshuffledistributedsampler_tpu_torch.streaming import StreamSpec
from partiallyshuffledistributedsampler_tpu_torch.streaming.spec import (
    WEIGHTS_RETAIN,
)

from test_torch_port_failover import replicated_pair, wait_for, wait_synced

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

pytestmark = pytest.mark.streaming

SECRET = b"psds-test-deployment-secret"

H = 64  #: default horizon extent for service-level tests


def plain_stream(world=2, horizon=H, **kw):
    kw.setdefault("window", 8)
    kw.setdefault("seed", 7)
    return StreamSpec.plain_stream(horizon, world=world, **kw, backend=BACKEND)


def mixture_stream(world=2, horizon=96, **kw):
    kw.setdefault("seed", 7)
    ms = MixtureSpec([100, 200, 50], [5, 3, 2], block=16)
    return StreamSpec.mixture_stream(horizon, mixture=ms, world=world, **kw, backend=BACKEND)


def feed(address, count, *, weights_delta=None):
    """One-shot feeder: extend the stream by ``count`` samples."""
    c = ServiceIndexClient(address, rank=None, batch=4, attach=True,
                           backoff_base=0.01, reconnect_timeout=10.0)
    try:
        return c.append(count, weights_delta=weights_delta)
    finally:
        c.close()


def stream_union(delivered):
    return Counter(
        np.concatenate(
            [a for got in delivered.values() for a in got]).tolist())


# ------------------------------------------------------------ spec laws


# ---------------------------------------------------- append + eligibility
def test_append_idempotent_and_eligibility_gate():
    """An APPEND replay is answered ``duplicate`` without re-counting,
    and a horizon is refused (typed, retryable) until fully appended."""
    spec = plain_stream(world=1)
    with IndexServer(spec) as srv:
        c = ServiceIndexClient(srv.address, rank=None, batch=4, attach=True,
                               backoff_base=0.01, reconnect_timeout=10.0)
        try:
            out = c.append(H // 2)
            assert out["appended"] == H // 2 and out["eligible"] == 0
            # a half-appended horizon is not servable: the typed refusal
            # paces the client until its deadline
            w = ServiceIndexClient(srv.address, rank=0, batch=16,
                                   backoff_base=0.01, reconnect_timeout=0.6)
            try:
                with pytest.raises(ServiceError) as ei:
                    next(iter(w.epoch_batches(0)))
                assert ei.value.code == "horizon_pending"
                assert w.metrics.report()["counters"]["stream_waits"] >= 1
            finally:
                w.close()
            # the daemon frees rank 0's lease when it sees the connection
            # end: reclaim it only then
            wait_for(lambda: srv._leases[0].get("owner") is None)
            out = c.append(H // 2)
            assert out["appended"] == H and out["eligible"] == 1
            with ServiceIndexClient(srv.address, rank=0, batch=16,
                                    backoff_base=0.01,
                                    reconnect_timeout=10.0) as w:
                got = np.concatenate(list(w.epoch_batches(0)))
            assert np.array_equal(got, spec.rank_indices(0, 0))
        finally:
            c.close()
        counters = srv.metrics.report()["counters"]
        assert counters.get("stream_appends", 0) == 2


def test_append_while_serving_exactly_once():
    """The core law: appends land mid-serve, ranks ride the typed
    backpressure, the advance barrier folds horizons 0->1->2, and the
    union of all delivered indices is every appended sample exactly
    once."""
    spec = plain_stream(world=2)
    delivered = {}
    lock = threading.Lock()
    with IndexServer(spec) as srv:
        addr = srv.address

        def feeder():
            c = ServiceIndexClient(addr, rank=None, batch=4, attach=True,
                                   backoff_base=0.01, reconnect_timeout=10.0)
            try:
                for _ in range(6):
                    c.append(32)
                    time.sleep(0.02)
            finally:
                c.close()

        def worker(r):
            c = ServiceIndexClient(addr, rank=r, batch=16,
                                   backoff_base=0.01, reconnect_timeout=10.0)
            got = []
            try:
                for arr in c.stream_batches(horizons=3):
                    got.append(np.asarray(arr))
            finally:
                with lock:
                    delivered[r] = got
                c.close()

        ths = [threading.Thread(target=worker, args=(r,)) for r in range(2)]
        for t in ths:
            t.start()
        time.sleep(0.05)
        ft = threading.Thread(target=feeder)
        ft.start()
        ft.join(30)
        for t in ths:
            t.join(30)
        assert not any(t.is_alive() for t in ths), "worker hung"
        assert srv.epoch == 2
        counters = srv.metrics.report()["counters"]
        hists = srv.metrics.report()["histograms"]
        assert counters.get("stream_appends", 0) == 6
        assert counters.get("horizon_advances", 0) == 2
        assert "horizon_advance_ms" in hists
        assert "append_visible_ms" in hists
    assert stream_union(delivered) == Counter(range(3 * H))


# --------------------------------------------------- mixture re-weighting
def test_reweight_and_capability_arm_bit_identical():
    """Online mixture re-weighting: a ``weights_delta`` riding an APPEND
    folds in at the next advance, moves the stream, and the signed
    capability carries the horizon's effective weights — the on-device
    regen arm is bit-identical to the served-batch arm."""
    served = {}
    regen = {}
    for arm, sink in (("served", served), ("capability", regen)):
        spec = mixture_stream(world=2)
        hz = spec.horizon
        with IndexServer(spec, capability_secret=SECRET) as srv:
            addr = srv.address
            feed(addr, hz)
            # the delta and the eligibility extension land atomically:
            # the advance into horizon 1 MUST see the folded weights
            feed(addr, hz, weights_delta=[3, 0, 0])
            feed(addr, hz)
            errors = []

            def worker(r):
                kw = dict(backoff_base=0.01, reconnect_timeout=20.0)
                if arm == "capability":
                    kw["capability_secret"] = SECRET
                c = ServiceIndexClient(addr, rank=r, batch=16,
                                       spec=mixture_stream(world=2), **kw)
                got = []
                try:
                    it = (c.capability_stream_batches(horizons=3)
                          if arm == "capability"
                          else c.stream_batches(horizons=3))
                    for arr in it:
                        got.append(np.asarray(arr))
                except Exception as exc:  # surfaced after join
                    errors.append((arm, r, exc))
                finally:
                    sink[r] = got
                    c.close()

            ths = [threading.Thread(target=worker, args=(r,))
                   for r in range(2)]
            for t in ths:
                t.start()
            for t in ths:
                t.join(30)
            assert not errors, errors
            assert srv.epoch == 2
            # the adopted weights live on the server's spec now
            assert srv.spec.weights_for(1) == (8, 3, 2)
    for r in range(2):
        a = np.concatenate(served[r])
        b = np.concatenate(regen[r])
        assert np.array_equal(a, b), f"capability arm diverged for rank {r}"
    # the re-weighted horizon genuinely moved vs. the base weights, and
    # matches the spec-level law for (5,3,2) + (3,0,0)
    base = mixture_stream(world=2)
    ref = base.with_stream_weights({1: (8, 3, 2)})
    for r in range(2):
        per_h = np.split(np.concatenate(served[r]), 3)
        assert not np.array_equal(per_h[1], base.rank_indices(1, r))
        assert np.array_equal(per_h[1], ref.rank_indices(1, r))
        assert np.array_equal(per_h[0], base.rank_indices(0, r))
        assert np.array_equal(per_h[2], ref.rank_indices(2, r))


# ------------------------------------------------------------ chaos matrix
@pytest.mark.chaos
def test_chaos_append_fault_never_skips_or_double_counts():
    """An APPEND lost before the WAL write (refusal or handler death)
    is replayed by the feeder's ``(feeder, stream_seq)`` retry and lands
    exactly once — the served stream neither skips nor double-serves."""
    for kind in ("error", "thread_death"):
        spec = plain_stream(world=1, horizon=32)
        with IndexServer(spec) as srv:
            c = ServiceIndexClient(srv.address, rank=None, batch=4,
                                   attach=True, backoff_base=0.01,
                                   reconnect_timeout=10.0)
            plan = F.FaultPlan([F.FaultRule(site="stream.append",
                                            kind=kind, count=1)])
            try:
                with plan:
                    out = c.append(32)
                assert out["appended"] == 32 and not out.get("duplicate")
                out = c.append(32)
                assert out["appended"] == 64
            finally:
                c.close()
            assert plan.fired("stream.append") == 1, \
                "fault never fired; the test is vacuous"
            with ServiceIndexClient(srv.address, rank=0, batch=8,
                                    backoff_base=0.01,
                                    reconnect_timeout=10.0) as w:
                got = np.concatenate(list(w.stream_batches(horizons=2)))
        assert Counter(got.tolist()) == Counter(range(64)), kind


@pytest.mark.chaos
def test_chaos_advance_abort_rolls_back_cleanly():
    """An injected abort at the advance barrier (pre-mutation) is a
    clean retryable refusal: the horizon generation does not move, the
    client retries, and the stream stays exactly-once."""
    spec = plain_stream(world=1, horizon=32)
    with IndexServer(spec) as srv:
        feed(srv.address, 64)
        plan = F.FaultPlan([F.FaultRule(site="stream.advance",
                                        kind="error", count=1)])
        with plan:
            with ServiceIndexClient(srv.address, rank=0, batch=8,
                                    backoff_base=0.01,
                                    reconnect_timeout=10.0) as w:
                got = np.concatenate(list(w.stream_batches(horizons=2)))
        assert plan.fired("stream.advance") == 1, \
            "fault never fired; the test is vacuous"
        assert srv.epoch == 1
        assert srv.metrics.report()["counters"]["horizon_advances"] == 1
    assert Counter(got.tolist()) == Counter(range(64))


# ------------------------------------------------------- mid-stream reshard
# The JAX file's mid-stream reshard case races its joiner against the
# advance barrier (a known JAX-package race); it is not carried over.


# -------------------------------------------------------- bounded state
@pytest.mark.durability
def test_watermark_gc_keeps_state_o_horizon(tmp_path):
    """The bounded-state guarantee: while appended samples grow without
    bound across >= 10 advances, every advance seals a forced checkpoint
    and the WAL GC truncates below the watermark — segment count and
    server cursor state stay O(horizon), not O(stream)."""
    hz, horizons = 32, 12
    spec = plain_stream(world=1, horizon=hz)
    snap = str(tmp_path / "snap.json")
    wal_dir = str(tmp_path / "wal")
    srv = IndexServer(spec, port=0, snapshot_path=snap, wal_dir=wal_dir,
                      fsync="off")
    host, port = srv.start()
    try:
        # tiny segments so rotation (and therefore GC) actually happens
        srv._wal.segment_bytes = 512
        done = threading.Event()

        def feeder():
            c = ServiceIndexClient((host, port), rank=None, batch=4,
                                   attach=True, backoff_base=0.01,
                                   reconnect_timeout=20.0)
            try:
                for _ in range(horizons * hz // 8):
                    c.append(8)
                    time.sleep(0.002)
            finally:
                done.set()
                c.close()

        ft = threading.Thread(target=feeder)
        ft.start()
        with ServiceIndexClient((host, port), rank=0, batch=16,
                                backoff_base=0.01,
                                reconnect_timeout=30.0) as w:
            got = np.concatenate(list(w.stream_batches(horizons=horizons)))
        ft.join(30)
        assert done.is_set()
        assert Counter(got.tolist()) == Counter(range(horizons * hz))
        assert srv.epoch == horizons - 1
        counters = srv.metrics.report()["counters"]
        assert counters.get("horizon_advances", 0) == horizons - 1
        assert counters.get("stream_gc_truncations", 0) >= 1, \
            "advances never truncated the WAL"
        # O(horizon), not O(stream): the live tail is bounded while the
        # record history (48 appends + every cursor ack) was not
        assert len(srv._wal.segment_paths()) <= 6
        assert json.load(open(snap)).get("wal_lsn", 0) > 0
        # cursor state is O(world), append dedup state O(feeders)
        assert len(srv._cursors) == 1
        assert len(srv._stream_seqs) == 1
    finally:
        srv.stop()


@pytest.mark.durability
def test_mid_stream_crash_recovery_bit_identical(tmp_path):
    """A daemon killed mid-stream recovers from checkpoint + tail replay
    and resumes at the exact horizon generation and ack watermark: the
    full delivered stream across the crash is bit-identical to the
    spec's."""
    hz = 32
    spec = plain_stream(world=1, horizon=hz)
    snap = str(tmp_path / "snap.json")
    wal_dir = str(tmp_path / "wal")
    srv = IndexServer(spec, port=0, snapshot_path=snap, wal_dir=wal_dir,
                      fsync="off")
    host, port = srv.start()
    feed((host, port), 4 * hz)
    with ServiceIndexClient((host, port), rank=0, batch=8,
                            backoff_base=0.01, reconnect_timeout=10.0) as w:
        before = np.concatenate(list(w.stream_batches(horizons=2)))
    assert srv.epoch == 1
    srv.kill()  # no graceful snapshot: recovery rides checkpoint + tail
    fresh = IndexServer(plain_stream(world=1, horizon=hz),
                        snapshot_path=snap, wal_dir=wal_dir, fsync="off")
    stats = recover_unstarted(fresh)
    assert stats is not None
    assert fresh.epoch == 1, "recovery lost the horizon generation"
    assert fresh._stream_appended == 4 * hz, "recovery lost appends"
    host, port = fresh.start()
    try:
        with ServiceIndexClient((host, port), rank=0, batch=8,
                                backoff_base=0.01,
                                reconnect_timeout=10.0) as w:
            after = np.concatenate(list(
                w.stream_batches(start_horizon=2, horizons=2)))
        assert fresh.epoch == 3
    finally:
        fresh.stop()
    ref = np.concatenate([np.asarray(spec.rank_indices(g, 0))
                          for g in range(4)])
    assert np.array_equal(np.concatenate([before, after]), ref)


# ------------------------------------------------------------- failover
@pytest.mark.failover
def test_failover_finishes_advance_at_barrier():
    """Kill the primary AT the advance barrier: every rank has acked
    horizon 0 and is about to name horizon 1.  The promoted standby owns
    the replicated ack cursors, passes the straggler gate, survives an
    injected handler death mid-advance, and commits the advance — the
    folded per-rank streams are bit-identical to the spec's."""
    spec = plain_stream(world=2, horizon=32)
    primary, standby = replicated_pair(spec)
    delivered = {}
    errors = []
    lock = threading.Lock()
    b_done0 = threading.Barrier(3)
    b_go1 = threading.Barrier(3)

    def worker(r):
        c = ServiceIndexClient(primary.address, rank=r, batch=8,
                               backoff_base=0.01, reconnect_timeout=20.0)
        got = []
        try:
            for arr in c.epoch_batches(0):
                got.append(np.asarray(arr))
            b_done0.wait(timeout=30)
            b_go1.wait(timeout=30)
            # the first request naming horizon 1 IS the advance barrier
            for arr in c.epoch_batches(1):
                got.append(np.asarray(arr))
        except Exception as exc:
            errors.append((r, exc))
        finally:
            with lock:
                delivered[r] = got
            c.close()

    plan = F.FaultPlan([F.FaultRule(site="stream.advance",
                                    kind="thread_death", count=1)])
    ths = [threading.Thread(target=worker, args=(r,)) for r in range(2)]
    try:
        feed(primary.address, 64)
        for t in ths:
            t.start()
        b_done0.wait(timeout=30)
        # every h0 ack (and the pinned per-rank totals) must be on the
        # standby before the primary dies, or the gate would stall
        wait_synced(primary, standby)
        with plan:
            primary.kill()
            b_go1.wait(timeout=30)
            for t in ths:
                t.join(30)
        assert not any(t.is_alive() for t in ths), "worker hung"
        assert not errors, errors
        assert plan.fired("stream.advance") >= 1, \
            "fault never fired; the test is vacuous"
        assert standby.role == "primary"
        assert standby.epoch == 1, "promoted standby never advanced"
        counters = standby.metrics.report()["counters"]
        assert counters.get("horizon_advances", 0) >= 1
    finally:
        primary.kill()
        standby.stop()
    for r in range(2):
        ref = np.concatenate([np.asarray(spec.rank_indices(g, r))
                              for g in range(2)])
        assert np.array_equal(np.concatenate(delivered[r]), ref), r
