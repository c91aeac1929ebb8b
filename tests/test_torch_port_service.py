"""The port's counterpart of the JAX package's ``tests/test_service.py``.

Every case runs on ``partiallyshuffledistributedsampler_tpu_torch`` with its
specs and loaders on ``backend="cpu"`` (no card), under the port's
lock-order sanitizer; the JAX file's text follows.

Index-serving service: daemon + clients == the local sampler, always.

Law under test: for any spec (plain / mixture / shard) the concatenated
batch stream a ``ServiceIndexClient`` delivers for ``(seed, epoch, rank)``
is bit-identical to ``PartialShuffleSpec.rank_indices`` — across many
concurrent clients, reconnects, a mid-epoch server kill + snapshot
restart, backpressure throttling, and lease eviction.  The transport may
retry and resend; the *delivered* stream must never gap or duplicate.
"""

import socket
import threading
import time
import warnings

import numpy as np
import pytest

# the JAX package's numpy reference of the law
from partiallyshuffledistributedsampler_tpu.ops.cpu import epoch_indices_np
from partiallyshuffledistributedsampler_tpu_torch.ops.mixture import MixtureSpec
from partiallyshuffledistributedsampler_tpu_torch.service import (
    IndexServer,
    PartialShuffleSpec,
    ServiceError,
    ServiceIndexClient,
    ServiceMetrics,
)
from partiallyshuffledistributedsampler_tpu_torch.service import protocol as P

from partiallyshuffledistributedsampler_tpu_torch.analysis import lockorder
from partiallyshuffledistributedsampler_tpu import (
    service as JS,
)
from partiallyshuffledistributedsampler_tpu.sampler.host_loader import (
    HostDataLoader as JHostDataLoader,
)
from partiallyshuffledistributedsampler_tpu_torch.sampler import (
    HostDataLoader,
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


def plain_spec(world=4, **kw):
    kw.setdefault("n", 530)
    kw.setdefault("window", 32)
    return PartialShuffleSpec.plain(kw.pop("n"), world=world, seed=7, **kw, backend=BACKEND)


def mixture_spec(world=4):
    ms = MixtureSpec([100, 200, 50], [5, 3, 2], block=16)
    return PartialShuffleSpec.mixture(ms, seed=3, world=world,
                                      epoch_samples=300, backend=BACKEND)


def shard_spec(world=4):
    return PartialShuffleSpec.shard([17, 5, 29, 11, 40, 8, 23, 9], window=4,
                                    seed=9, world=world,
                                    within_shard_shuffle=True, backend=BACKEND)


SPECS = {"plain": plain_spec, "mixture": mixture_spec, "shard": shard_spec}


# --------------------------------------------------------------- protocol
def test_protocol_roundtrip_over_socketpair():
    a, b = socket.socketpair()
    try:
        arr = np.arange(100, dtype=np.int64) * 3
        header, payload = P.encode_indices(arr)
        header["seq"] = 5
        P.send_msg(a, P.MSG_BATCH, header, payload)
        msg, h, pl = P.recv_msg(b)
        assert msg == P.MSG_BATCH and h["seq"] == 5
        assert np.array_equal(P.decode_indices(h, pl), arr)
    finally:
        a.close()
        b.close()


def test_protocol_rejects_malformed_frames():
    a, b = socket.socketpair()
    try:
        a.sendall((1 << 30).to_bytes(4, "big"))  # body_len over MAX_FRAME
        a.close()
        with pytest.raises(P.ProtocolError):
            P.recv_msg(b)
    finally:
        b.close()


def test_protocol_closed_peer_raises_connection_error():
    a, b = socket.socketpair()
    a.close()
    try:
        with pytest.raises(ConnectionError):
            P.recv_msg(b)
    finally:
        b.close()


def test_decode_rejects_length_mismatch():
    with pytest.raises(P.ProtocolError):
        P.decode_indices({"dtype": "<i8", "count": 10}, b"\0" * 16)


# ------------------------------------------------------------------- spec
def test_spec_wire_roundtrip_all_modes():
    for name, build in SPECS.items():
        spec = build()
        back = PartialShuffleSpec.from_wire(spec.to_wire(), backend=BACKEND)
        assert back == spec, name
        assert back.fingerprint() == spec.fingerprint()


def test_spec_backend_outside_fingerprint():
    a = plain_spec(world=2)
    b = PartialShuffleSpec.from_wire(a.to_wire(), backend="cpu")
    assert a.fingerprint() == b.fingerprint()


def test_spec_plain_matches_reference_stream():
    spec = plain_spec(world=2)
    for rank in range(2):
        ref = epoch_indices_np(530, 32, 7, 4, rank, 2)
        assert np.array_equal(spec.rank_indices(4, rank), ref)


def test_spec_rejects_unknown_kwargs():
    with pytest.raises(TypeError):
        PartialShuffleSpec.plain(100, window=8, banana=True, backend=BACKEND)


# ------------------------------------------------- served == local streams
@pytest.mark.parametrize("mode", sorted(SPECS))
def test_four_clients_stream_equals_local(mode):
    spec = SPECS[mode](world=4)
    results, errors = {}, []

    def run(rank):
        try:
            with ServiceIndexClient((host, port), rank=rank, batch=41) as c:
                results[rank] = c.epoch_indices(2)
        except BaseException as exc:  # surfaced below
            errors.append((rank, exc))

    with IndexServer(spec) as srv:
        host, port = srv.address
        threads = [threading.Thread(target=run, args=(r,)) for r in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert not errors, errors
    for rank in range(4):
        assert np.array_equal(results[rank], spec.rank_indices(2, rank)), rank


def test_auto_rank_claims_are_distinct():
    spec = plain_spec(world=3)
    with IndexServer(spec) as srv:
        clients = [ServiceIndexClient(srv.address) for _ in range(3)]
        try:
            for c in clients:
                c._ensure_connected()
            assert sorted(c.rank for c in clients) == [0, 1, 2]
        finally:
            for c in clients:
                c.close()


def test_batches_follow_transport_batch_size():
    spec = plain_spec(world=1, n=300)
    with IndexServer(spec) as srv:
        with ServiceIndexClient(srv.address, batch=64) as c:
            sizes = [len(b) for b in c.epoch_batches(0)]
    total = spec.num_samples(0)
    assert sum(sizes) == total
    assert all(s == 64 for s in sizes[:-1])


def test_spec_fingerprint_mismatch_refused():
    spec = plain_spec(world=2)
    other = plain_spec(world=2, n=531)
    with IndexServer(spec) as srv:
        c = ServiceIndexClient(srv.address, spec=other, reconnect_timeout=1.0)
        with pytest.raises(ServiceError) as ei:
            c._ensure_connected()
        # typed refusal carrying both world-stripped fingerprints
        assert ei.value.code == "spec_mismatch"
        assert ei.value.header["server_fingerprint"] == \
            spec.fingerprint(include_world=False)
        assert ei.value.header["client_fingerprint"] == \
            other.fingerprint(include_world=False)


# --------------------------------------------------- backpressure + leases
def _raw_hello(addr, rank, batch=32):
    sock = socket.create_connection(addr, timeout=5.0)
    P.send_msg(sock, P.MSG_HELLO,
               {"proto": P.PROTOCOL_VERSION, "rank": rank, "batch": batch})
    msg, header, _ = P.recv_msg(sock)
    return sock, msg, header


def test_backpressure_throttles_runaway_seq():
    spec = plain_spec(world=1)
    with IndexServer(spec, max_inflight=2) as srv:
        sock, msg, _ = _raw_hello(srv.address, rank=0)
        try:
            assert msg == P.MSG_WELCOME
            # nothing acked yet: seq 3 > acked(-1) + max_inflight(2)
            P.send_msg(sock, P.MSG_GET_BATCH,
                       {"rank": 0, "epoch": 0, "seq": 3, "ack": -1})
            msg, header, _ = P.recv_msg(sock)
            assert msg == P.MSG_ERROR and header["code"] == "throttle"
            assert header["retry_ms"] > 0
            # acking up to 1 opens the window for seq 3
            P.send_msg(sock, P.MSG_GET_BATCH,
                       {"rank": 0, "epoch": 0, "seq": 3, "ack": 1})
            msg, header, _ = P.recv_msg(sock)
            assert msg == P.MSG_BATCH and header["seq"] == 3
        finally:
            sock.close()
    assert srv.metrics.report()["counters"].get("throttled", 0) >= 1


def test_rank_lease_conflict_and_release_on_disconnect():
    spec = plain_spec(world=1)
    with IndexServer(spec) as srv:
        holder, msg, _ = _raw_hello(srv.address, rank=0)
        assert msg == P.MSG_WELCOME
        rival, msg, header = _raw_hello(srv.address, rank=0)
        rival.close()
        assert msg == P.MSG_ERROR and header["code"] == "rank_taken"
        holder.close()  # disconnect frees the lease immediately
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            again, msg, _ = _raw_hello(srv.address, rank=0)
            again.close()
            if msg == P.MSG_WELCOME:
                break
            time.sleep(0.02)
        assert msg == P.MSG_WELCOME


def test_heartbeat_timeout_evicts_silent_client():
    spec = plain_spec(world=1)
    with IndexServer(spec, heartbeat_timeout=0.15) as srv:
        silent, msg, _ = _raw_hello(srv.address, rank=0)
        try:
            assert msg == P.MSG_WELCOME
            time.sleep(0.3)  # no heartbeats: lease goes stale
            fresh, msg, _ = _raw_hello(srv.address, rank=0)
            fresh.close()
            assert msg == P.MSG_WELCOME  # stale lease evicted at claim
        finally:
            silent.close()
    assert srv.metrics.report()["counters"].get("evictions", 0) >= 1


def test_lease_eviction_timing_exact_with_injected_clock():
    """Eviction timing pinned down deterministically: a lease is held
    through exactly ``heartbeat_timeout`` of silence and reclaimable
    immediately past it — no sleeps, the server runs on a fake clock."""
    class FakeClock:
        def __init__(self):
            self.t = 1000.0

        def __call__(self):
            return self.t

    clk = FakeClock()
    spec = plain_spec(world=1)
    with IndexServer(spec, heartbeat_timeout=10.0, clock=clk) as srv:
        holder, msg, _ = _raw_hello(srv.address, rank=0)
        try:
            assert msg == P.MSG_WELCOME
            # silence for EXACTLY the ttl: still leased (eviction is
            # strictly-greater-than, so a heartbeat landing on the
            # deadline keeps its lease)
            clk.t += 10.0
            srv._sweep_leases()
            rival, msg, header = _raw_hello(srv.address, rank=0)
            rival.close()
            assert msg == P.MSG_ERROR and header["code"] == "rank_taken"
            assert srv.metrics.report()["counters"].get("evictions", 0) == 0
            # one tick past the ttl: swept, counted, and reclaimable
            clk.t += 0.001
            srv._sweep_leases()
            assert srv.metrics.report()["counters"].get("evictions", 0) == 1
            fresh, msg, _ = _raw_hello(srv.address, rank=0)
            fresh.close()
            assert msg == P.MSG_WELCOME
        finally:
            holder.close()


def test_heartbeat_keeps_lease_alive():
    spec = plain_spec(world=1)
    with IndexServer(spec, heartbeat_timeout=0.4) as srv:
        with ServiceIndexClient(srv.address, rank=0) as c:
            for _ in range(4):
                time.sleep(0.1)
                c.heartbeat()
            rival, msg, header = _raw_hello(srv.address, rank=0)
            rival.close()
            assert msg == P.MSG_ERROR and header["code"] == "rank_taken"


# ------------------------------------------------------- resends + resume
def test_replayed_seq_is_idempotent():
    spec = plain_spec(world=1)
    with IndexServer(spec) as srv:
        sock, msg, _ = _raw_hello(srv.address, rank=0)
        try:
            replies = []
            for _ in range(2):  # same seq twice: a reconnect replay
                P.send_msg(sock, P.MSG_GET_BATCH,
                           {"rank": 0, "epoch": 1, "seq": 0, "ack": -1})
                _, header, payload = P.recv_msg(sock)
                replies.append(P.decode_indices(header, payload))
            assert np.array_equal(replies[0], replies[1])
        finally:
            sock.close()
    assert srv.metrics.report()["counters"].get("resends", 0) >= 1


def test_client_state_dict_resumes_exactly_once():
    spec = plain_spec(world=1)
    with IndexServer(spec) as srv:
        c = ServiceIndexClient(srv.address, batch=32)
        first = []
        for i, arr in enumerate(c.epoch_batches(3)):
            first.append(arr)
            if i == 2:
                state = c.state_dict()
                break
        c.close()
        c2 = ServiceIndexClient(srv.address, batch=32)
        c2.load_state_dict(state)
        rest = list(c2.resume_batches())
        c2.close()
    stream = np.concatenate(first + rest)
    assert np.array_equal(stream, spec.rank_indices(3, 0))


# --------------------------------------------- kill mid-epoch, restart
@pytest.mark.parametrize("mode", sorted(SPECS))
def test_server_kill_and_restart_stream_bit_identical(mode):
    """The acceptance law: a server killed mid-epoch and restarted from
    its snapshot serves the remaining batches with no gap and no
    duplicate — the client's delivered stream equals the local run."""
    spec = SPECS[mode](world=2)
    results, errors = {}, []

    def run(rank, barrier):
        try:
            c = ServiceIndexClient((host, port), rank=rank, batch=23,
                                   reconnect_timeout=20.0)
            got = []
            for i, arr in enumerate(c.epoch_batches(6)):
                got.append(arr)
                if i == 2:
                    barrier.wait(timeout=10.0)  # both ranks mid-epoch
                    barrier.wait(timeout=10.0)  # server is down + back up
            results[rank] = np.concatenate(got)
            c.close()
        except BaseException as exc:
            errors.append((rank, exc))

    snap = None
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        snap = td + "/service.json"
        srv = IndexServer(spec, snapshot_path=snap, snapshot_interval=1)
        host, port = srv.start()
        barrier = threading.Barrier(3)
        threads = [threading.Thread(target=run, args=(r, barrier))
                   for r in range(2)]
        for t in threads:
            t.start()
        barrier.wait(timeout=10.0)  # all clients hold mid-epoch
        srv.stop()
        srv2 = IndexServer(spec, host=host, port=port, snapshot_path=snap,
                           snapshot_interval=1)
        srv2.start()
        barrier.wait(timeout=10.0)  # release the clients
        for t in threads:
            t.join(timeout=30.0)
        srv2.stop()
    assert not errors, errors
    for rank in range(2):
        assert np.array_equal(results[rank], spec.rank_indices(6, rank)), rank


def test_snapshot_restores_epoch_and_refuses_wrong_spec(tmp_path):
    snap = str(tmp_path / "svc.json")
    spec = plain_spec(world=1)
    with IndexServer(spec, snapshot_path=snap, snapshot_interval=1) as srv:
        with ServiceIndexClient(srv.address) as c:
            c.set_epoch(9)
    srv2 = IndexServer(spec, snapshot_path=snap)
    srv2.start()
    try:
        with ServiceIndexClient(srv2.address) as c:
            assert c.server_epoch == 9
    finally:
        srv2.stop()
    with pytest.raises(ValueError):
        IndexServer(plain_spec(world=1, n=531), snapshot_path=snap).start()


# ------------------------------------------------------- loader + metrics
def test_host_loader_consumes_service_stream():
    from partiallyshuffledistributedsampler_tpu_torch.sampler import HostDataLoader

    data = {"x": np.arange(530 * 2).reshape(530, 2), "y": np.arange(530)}
    spec = plain_spec(world=2)
    with IndexServer(spec) as srv:
        with ServiceIndexClient(srv.address, rank=1, batch=64) as c:
            served = HostDataLoader(data, window=32, seed=7, rank=1, world=2,
                                    batch=64, index_client=c, index_backend=BACKEND, device="cpu")
            got = [np.asarray(b["y"]) for b in served.epoch(2)]
            # the port's boundary worker is not a daemon thread: let its
            # prefetch of epoch 3 finish while the daemon is up
            served.close()
    ref = spec.rank_indices(2, 1)
    whole = len(ref) // 64
    for b, s in zip(got, range(whole)):
        assert np.array_equal(b, ref[s * 64:(s + 1) * 64])


def test_service_metrics_per_client_report():
    reg_metrics = ServiceMetrics()
    spec = plain_spec(world=2)
    with IndexServer(spec, metrics=reg_metrics) as srv:
        with ServiceIndexClient(srv.address, rank=0, batch=64) as c:
            c.epoch_indices(0)
            report = c.server_metrics()
    assert report["counters"]["batches_served"] >= 1
    assert report["clients"]["0"]["batches_served"] >= 1
    assert "epoch_regen_ms" in report["timers"]


@pytest.mark.slow
def test_soak_many_epochs_many_clients():
    """Soak: 4 clients x 5 epochs with a throttling window of 1 — every
    delivered stream still equals the local run."""
    spec = plain_spec(world=4)
    with IndexServer(spec, max_inflight=1) as srv:
        host, port = srv.address
        errors = []

        def run(rank):
            try:
                with ServiceIndexClient((host, port), rank=rank,
                                        batch=17) as c:
                    for epoch in range(5):
                        got = c.epoch_indices(epoch)
                        ref = spec.rank_indices(epoch, rank)
                        assert np.array_equal(got, ref), (rank, epoch)
            except BaseException as exc:
                errors.append((rank, exc))

        threads = [threading.Thread(target=run, args=(r,)) for r in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors


# ---------------------------------- the served loaders of both packages


LOADER_SECRET = b"psds-test-deployment-secret"


def _loader_pair(**kw):
    """A JAX and a port ``HostDataLoader`` of one config, each served by a
    daemon of its own package: ``[(loader, server, client), ...]``."""
    data = {"x": np.arange(530 * 2).reshape(530, 2), "y": np.arange(530)}
    out = []
    for S, L, extra in ((JS, JHostDataLoader, {}),
                        (None, HostDataLoader,
                         {"index_backend": BACKEND, "device": "cpu"})):
        if S is None:
            srv = IndexServer(plain_spec(world=2),
                              capability_secret=LOADER_SECRET)
            C = ServiceIndexClient
        else:
            srv = S.IndexServer(
                S.PartialShuffleSpec.plain(530, window=32, seed=7, world=2),
                capability_secret=LOADER_SECRET)
            C = S.ServiceIndexClient
        srv.start()
        c = C(srv.address, rank=1, batch=64, backoff_base=0.01,
              reconnect_timeout=0.5, capability_secret=LOADER_SECRET,
              spec=srv.spec)
        loader = L(data, window=32, seed=7, rank=1, world=2, batch=64,
                   index_client=c, boundary_prefetch=False, **extra, **kw)
        out.append((loader, srv, c))
    return out


def _batches(loader, epoch):
    return [(np.asarray(b["x"]), np.asarray(b["y"]))
            for b in loader.epoch(epoch)]


@pytest.mark.parametrize("capability_mode", [False, True])
def test_served_loaders_of_both_packages_agree_batch_by_batch(
        capability_mode):
    """``index_client`` (and ``capability_mode``) through each package's
    loader and daemon: the same batches, then a daemon killed and both
    loaders degraded to a local regen of the same next epoch."""
    pair = _loader_pair(capability_mode=capability_mode)
    try:
        got = [[_batches(ld, e) for e in (2, 3)] for ld, _, _ in pair]
        for _, srv, _ in pair:
            srv.kill()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for (ld, _, _), g in zip(pair, got):
                g.append(_batches(ld, 4))
                assert ld.degraded
        assert sum("unavailable" in str(w.message) for w in caught) == 2
        counters = [c.metrics.report()["counters"] for _, _, c in pair]
    finally:
        for ld, srv, c in pair:
            c.close()
            srv.kill()
    assert counters[0].get("degraded_mode") == counters[1].get(
        "degraded_mode") == 1
    if capability_mode:
        assert all(c.get("capability_fallbacks", 0) == 0 for c in counters)
    spec = plain_spec(world=2)
    for e, (jb, pb) in zip((2, 3, 4), zip(*got)):
        ref = spec.rank_indices(e, 1)
        assert len(jb) == len(pb) == len(ref) // 64
        for s, ((jx, jy), (px, py)) in enumerate(zip(jb, pb)):
            assert np.array_equal(jx, px) and np.array_equal(jy, py)
            assert np.array_equal(py, ref[s * 64:(s + 1) * 64])


def test_served_sampling_specs_equal_their_local_streams():
    """The three sampling modes through a daemon: weighted served ==
    local regen on every rank, a prioritized re-weighting carried on the
    wire folds like the local one, and a dedup stream repeats no id
    across epochs; each equal to the JAX package's spec."""
    from partiallyshuffledistributedsampler_tpu.sampling import (
        SamplingSpec as JSamplingSpec,
    )
    from partiallyshuffledistributedsampler_tpu_torch.sampling import (
        SamplingSpec,
    )

    sizes = (9000, 6000, 5000)
    kw = dict(epoch_samples=8192, window=128, seed=11, world=2)
    spec = SamplingSpec.weighted(sizes, (5, 1, 2), backend=BACKEND, **kw)
    jspec = JSamplingSpec.weighted(sizes, (5, 1, 2), **kw)
    with IndexServer(spec) as d:
        for r in range(2):
            with ServiceIndexClient(d.address, rank=r, batch=1024) as c:
                got = np.concatenate(list(c.epoch_batches(0)))
            assert np.array_equal(got, spec.rank_indices(0, r))
            assert np.array_equal(got, np.asarray(jspec.rank_indices(0, r)))
    kw = dict(epoch_samples=4096, window=64, seed=7, world=1)
    p = SamplingSpec.prioritized(sizes, (1, 1, 1), backend=BACKEND, **kw)
    jp = JSamplingSpec.prioritized(sizes, (1, 1, 1), **kw)
    with IndexServer(p) as d:
        with ServiceIndexClient(d.address, rank=0, batch=1024) as c:
            c.set_epoch(1, weights_delta=[9, 0, 0])
            e1 = np.concatenate(list(c.epoch_batches(1)))
    want = p.with_stream_weights({1: (10, 1, 1)}).rank_indices(1, 0)
    assert np.array_equal(e1, want)
    assert np.array_equal(e1, np.asarray(
        jp.with_stream_weights({1: (10, 1, 1)}).rank_indices(1, 0)))
    dd = SamplingSpec.deduped((4000, 3000, 3000), epoch_samples=2048,
                              window=64, seed=3, world=1, backend=BACKEND)
    with IndexServer(dd) as d:
        with ServiceIndexClient(d.address, rank=0, batch=512) as c:
            u = np.concatenate([np.concatenate(list(c.epoch_batches(e)))
                                for e in (0, 1)])
    assert len(set(u.tolist())) == len(u) == 4096
