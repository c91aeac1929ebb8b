"""The port's counterpart of the JAX package's ``tests/test_elastic_service.py``.

Every case runs on ``partiallyshuffledistributedsampler_tpu_torch`` with its
specs and loaders on ``backend="cpu"`` (no card), under the port's
lock-order sanitizer; the JAX file's text follows.

Elastic membership: coordinated mid-epoch resharding through the daemon.

The acceptance law (SPEC.md §6, served elastically): for a world change
``old_world -> new_world`` mid-epoch, the union of pre-barrier batches
delivered to the old ranks and post-barrier batches delivered to the new
ranks equals the uninterrupted epoch stream as a multiset, modulo the new
partition's wrap-padding — whose extras are bounded by ``new_world`` base
units (samples, or whole shards in shard mode) per committed reshard and
must replay existing epoch values, never invent or drop any.

Covered here: the explicit ``RESHARD`` matrix over (4,3), (3,5), (8,2) ×
all three spec modes; ``LEAVE`` preemption drains (graceful and
grace-expired); membership-timeout eviction with an injected clock; the
kill-the-daemon-between-barrier-and-first-post-reshard-batch resume from
snapshot v2; a two-reshard cascade with restarts between; protocol
version negotiation; the typed ``ReshardInProgress`` back-pressure; and
``HostDataLoader`` riding through a world change with its degraded-mode
composition bit-matching the live composite stream.
"""

from __future__ import annotations

import json
import socket
import threading
import time
import warnings
from collections import Counter

import numpy as np
import pytest

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
    ReshardInProgress,
    ServiceError,
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

pytestmark = pytest.mark.elastic

_SHARD_SIZES = [13, 7, 29, 17, 11, 23, 5, 19, 31, 37, 3, 41, 43, 9, 21, 15]


def build_spec(mode, world):
    if mode == "plain":
        return PartialShuffleSpec.plain(997, window=64, seed=7, world=world, backend=BACKEND)
    if mode == "mixture":
        mx = MixtureSpec([400, 300, 200], [5, 3, 2], windows=32)
        return PartialShuffleSpec.mixture(mx, seed=7, world=world,
                                          epoch_samples=600, backend=BACKEND)
    return PartialShuffleSpec.shard(_SHARD_SIZES, window=4, seed=7,
                                    world=world, backend=BACKEND)


#: wrap-pad extras come in whole base units: one sample, or one shard
MAX_UNIT = {"plain": 1, "mixture": 1, "shard": max(_SHARD_SIZES)}


def epoch_union_ref(spec, epoch=0):
    return np.concatenate([np.asarray(spec.rank_indices(epoch, r))
                           for r in range(spec.world)])


def assert_union_law(union, ref, *, new_world, max_unit, reshards=1):
    """No epoch value missing; extras bounded by the wrap-pad allowance
    and drawn only from values the epoch actually contains."""
    combined = Counter(np.asarray(union).tolist())
    full = Counter(np.asarray(ref).tolist())
    missing = full - combined
    assert not missing, (
        f"dropped epoch values: {list(missing.items())[:8]}")
    extras = combined - full
    n_extra = sum(extras.values())
    assert n_extra <= reshards * new_world * max_unit, (
        f"{n_extra} extras exceed the wrap-pad allowance "
        f"{reshards} x {new_world} x {max_unit}")
    assert set(extras) <= set(full), "extras invented unknown values"


# ------------------------------------------------------ RESHARD matrix
@pytest.mark.parametrize("mode", ["plain", "mixture", "shard"])
@pytest.mark.parametrize("old_world,new_world", [(4, 3), (3, 5), (8, 2)])
def test_reshard_matrix_exactly_once(mode, old_world, new_world):
    """Live threaded clients, barrier frozen mid-stream: union of old
    ranks' pre-barrier and new ranks' post-barrier deliveries is the
    uninterrupted epoch modulo wrap-padding, for shrink AND growth."""
    spec = build_spec(mode, old_world)
    ref = epoch_union_ref(spec)
    delivered = {}
    lock = threading.Lock()
    b_hit = threading.Barrier(old_world)
    b_go = threading.Barrier(old_world)
    with IndexServer(spec) as srv:
        addr = srv.address

        def worker(r):
            got = []
            c = ServiceIndexClient(addr, rank=r, batch=23,
                                   backoff_base=0.01,
                                   reconnect_timeout=20.0)
            try:
                it = c.epoch_batches(0)
                for _ in range(1 + r):
                    try:
                        got.append(next(it))
                    except StopIteration:
                        break
                b_hit.wait(timeout=30.0)
                if r == 0:
                    c.reshard(new_world)
                b_go.wait(timeout=30.0)
                for arr in it:
                    got.append(arr)
            finally:
                with lock:
                    delivered[r] = got
                c.close()

        def joiner(j):
            c = ServiceIndexClient(addr, rank=None, batch=23,
                                   backoff_base=0.01,
                                   reconnect_timeout=20.0)
            try:
                got = list(c.epoch_batches(0))
            finally:
                with lock:
                    delivered[("joiner", j)] = got
                c.close()

        threads = [threading.Thread(target=worker, args=(r,))
                   for r in range(old_world)]
        for t in threads:
            t.start()
        if new_world > old_world:
            time.sleep(0.6)  # let the barrier commit before joiners dial
            for j in range(new_world - old_world):
                jt = threading.Thread(target=joiner, args=(j,))
                jt.start()
                threads.append(jt)
        for t in threads:
            t.join(timeout=60.0)
            assert not t.is_alive(), "elastic worker hung"
        snap = srv._state_dict()
    assert snap["generation"] == 1
    assert len(snap["layers"]) == 1 and snap["layers"][0][0] == old_world
    union = np.concatenate(
        [np.concatenate(v) if v else np.empty(0, np.int64)
         for v in delivered.values()])
    assert_union_law(union, ref, new_world=new_world,
                     max_unit=MAX_UNIT[mode])


# ----------------------------------------------------------- LEAVE drain
@pytest.mark.parametrize("mode", ["plain", "mixture", "shard"])
def test_leave_drains_to_barrier_then_terminal_eof(mode):
    """A LEAVE keeps serving the leaver its pre-barrier allocation, ends
    its stream with the terminal drain eof, and the displaced survivor
    adopts the freed slot — 2 -> 1 has no wrap-pad, so the union is
    exactly the uninterrupted epoch."""
    spec = build_spec(mode, 2)
    ref = epoch_union_ref(spec)
    with IndexServer(spec) as srv:
        c0 = ServiceIndexClient(srv.address, rank=0, batch=31,
                                backoff_base=0.01, reconnect_timeout=10.0)
        c1 = ServiceIndexClient(srv.address, rank=1, batch=31,
                                backoff_base=0.01, reconnect_timeout=10.0)
        try:
            it0 = c0.epoch_batches(0)
            it1 = c1.epoch_batches(0)
            got0 = [next(it0)]
            got1 = [next(it1), next(it1)]
            rep = c0.leave(grace_ms=60_000)
            assert rep["reshard"] is True
            assert rep["target_world"] == 1
            target = rep["target_samples"]
            assert target is not None and target >= 31
            got0.extend(it0)  # drains to the barrier, then terminal eof
            leaver = np.concatenate(got0)
            assert len(leaver) == target
            assert np.array_equal(
                leaver, np.asarray(spec.rank_indices(0, 0))[:target])
            got1.extend(it1)  # displaced; rejoins as the world-1 rank 0
            assert c1.generation == 1
            assert c1.rank == 0 and c1.world == 1
            assert c1.metrics.report()["counters"].get(
                "reshards_ridden", 0) >= 1
            union = np.concatenate([leaver, np.concatenate(got1)])
            assert np.array_equal(np.sort(union), np.sort(ref))
            counters = srv.metrics.report()["counters"]
            assert counters.get("leaves", 0) >= 1
            assert counters.get("reshards", 0) == 1
            assert counters.get("orphaned", 0) == 0
        finally:
            c0.close()
            c1.close()


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = float(t)

    def __call__(self):
        return self.t


def test_leave_grace_expiry_orphans_the_remainder():
    """A leaver that stops consuming past its grace deadline is declared
    dead; its unserved span becomes orphan descriptors served as the new
    rank 0's prefix — nothing is lost."""
    spec = build_spec("plain", 2)
    ref = epoch_union_ref(spec)
    clk = FakeClock()
    srv = IndexServer(spec, clock=clk)
    srv.start()
    c0 = ServiceIndexClient(srv.address, rank=0, batch=31,
                            backoff_base=0.01, reconnect_timeout=10.0)
    c1 = ServiceIndexClient(srv.address, rank=1, batch=31,
                            backoff_base=0.01, reconnect_timeout=10.0)
    try:
        it0 = c0.epoch_batches(0)
        it1 = c1.epoch_batches(0)
        got0 = [next(it0)]
        got1 = [next(it1), next(it1)]
        rep = c0.leave(grace_ms=100)
        assert rep["reshard"] is True
        c1.heartbeat()  # flush the survivor's delivered ack: it drains
        # the leaver goes silent instead of draining; its grace expires
        clk.t += 1.0
        srv._sweep_leases()
        snap = srv._state_dict()
        assert snap["generation"] == 1
        assert snap["orphans"], "grace expiry must orphan the remainder"
        assert srv.metrics.report()["counters"].get("orphaned", 0) == 31
        got1.extend(it1)  # adopts rank 0: orphan prefix + world-1 stream
        union = np.concatenate(got0 + got1)
        assert np.array_equal(np.sort(union), np.sort(ref))
    finally:
        c0.close()
        c1.close()
        srv.stop()


def test_membership_timeout_evicts_vacant_rank_and_reshards():
    """A rank whose lease stays vacant past membership_timeout is
    resharded out by the sweep — no LEAVE, no RESHARD RPC — and its
    consumed watermark bounds the orphaned span."""
    spec = build_spec("plain", 2)
    ref = epoch_union_ref(spec)
    clk = FakeClock()
    srv = IndexServer(spec, membership_timeout=5.0, clock=clk)
    srv.start()
    c1 = ServiceIndexClient(srv.address, rank=1, batch=31,
                            backoff_base=0.01, reconnect_timeout=10.0)
    try:
        c0 = ServiceIndexClient(srv.address, rank=0, batch=31)
        it0 = c0.epoch_batches(0)
        got0 = [next(it0)]
        c0.close()  # preempted without notice: lease goes vacant
        it1 = c1.epoch_batches(0)
        got1 = [next(it1), next(it1)]
        clk.t += 6.0
        srv._sweep_leases()  # triggers the eviction reshard (drain phase)
        c1.heartbeat()       # survivor's delivered ack completes the drain
        snap = srv._state_dict()
        assert snap["generation"] == 1, "sweep must trigger the reshard"
        assert srv.metrics.report()["counters"].get("reshard_triggers",
                                                    0) >= 1
        got1.extend(it1)
        union = np.concatenate(got0 + got1)
        assert np.array_equal(np.sort(union), np.sort(ref))
    finally:
        c1.close()
        srv.stop()


# ------------------------------------------------- kill + restart resume
@pytest.mark.parametrize("mode", ["plain", "shard"])
def test_kill_restart_between_barrier_and_first_post_batch(mode, tmp_path):
    """The daemon dies right after the barrier commits and before any
    post-reshard batch is served; the restarted daemon resumes the
    cascade from snapshot v2 and the union law still holds."""
    spec = build_spec(mode, 4)
    ref = epoch_union_ref(spec)
    snap_path = str(tmp_path / "snap.json")
    srv = IndexServer(spec, snapshot_path=snap_path, snapshot_interval=1)
    host, port = srv.start()
    clients = [ServiceIndexClient((host, port), rank=r, batch=23,
                                  backoff_base=0.01, reconnect_timeout=20.0)
               for r in range(4)]
    its = [c.epoch_batches(0) for c in clients]
    srv2 = None
    try:
        pre = {r: [next(its[r]), next(its[r])] for r in range(4)}
        rep = clients[0].reshard(3)
        # the barrier commits only on ACKED delivery, and acks trail the
        # last delivered batch by one request — never inside the trigger
        assert rep["committed"] is False
        # drain every rank to its clamped per-rank target (in shard mode
        # the barrier cuts on whole SHARDS, so the targets differ), then
        # flush the final delivery acks by heartbeat — the last commits
        targets = {int(r): int(t)
                   for r, t in srv._reshard["targets"].items()}
        for r in range(4):
            need = targets[r] - 46
            while need > 0:
                arr = next(its[r])
                pre[r].append(arr)
                need -= len(arr)
            assert need == 0, "drain overshot the barrier target"
        for c in clients:
            c.heartbeat()
        state = json.loads(open(snap_path).read())
        assert state["format"] == 2
        assert state["generation"] == 1
        assert len(state["layers"]) == 1 and state["layers"][0][0] == 4
        srv.stop()  # killed before ANY post-reshard batch was served
        srv2 = IndexServer(spec, host=host, port=port,
                           snapshot_path=snap_path, snapshot_interval=1)
        srv2.start()
        post = {}
        for r in range(3):
            post[r] = list(its[r])
            got = (np.concatenate(post[r]) if post[r]
                   else np.empty(0, np.int64))
            want = np.asarray(spec.with_world(3).rank_indices(
                0, r, layers=[tuple(state["layers"][0])]))
            assert np.array_equal(got, want), f"rank {r} post-reshard"
        # the displaced rank finds no free unserved slot and bows out
        post[3] = list(its[3])
        assert post[3] == []
        assert clients[3].metrics.report()["counters"].get(
            "membership_lost", 0) >= 1
        union = np.concatenate(
            [np.concatenate(pre[r]) for r in range(4)]
            + [np.concatenate(post[r]) for r in range(3)])
        assert_union_law(union, ref, new_world=3, max_unit=MAX_UNIT[mode])
    finally:
        for c in clients:
            c.close()
        srv.stop()
        if srv2 is not None:
            srv2.stop()


def test_cascading_reshards_with_restart_between():
    """Two successive world changes mid-remainder (4 -> 3 -> 2) with the
    daemon killed and restarted after each commit: the cascade layers
    stack per SPEC.md §6 and every generation's stream is bit-exact."""
    spec = build_spec("plain", 4)
    ref = epoch_union_ref(spec)
    snap_path = None
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        snap_path = td + "/snap.json"
        srv = IndexServer(spec, snapshot_path=snap_path, snapshot_interval=1)
        host, port = srv.start()
        delivered = []

        # generation 0: four ranks consume equally, then the world shrinks
        gen0 = [ServiceIndexClient((host, port), rank=r, batch=23)
                for r in range(4)]
        its = [c.epoch_batches(0) for c in gen0]
        for it in its:
            delivered.append(next(it))
            delivered.append(next(it))
        assert gen0[0].reshard(3)["committed"] is False
        for c in gen0:
            c.heartbeat()  # flush delivery acks; the last one commits
        for c in gen0:
            c.close()
        srv.stop()

        srv = IndexServer(spec, host=host, port=port,
                          snapshot_path=snap_path, snapshot_interval=1)
        srv.start()
        layers1 = [(4, 46)]
        gen1 = [ServiceIndexClient((host, port), rank=r, batch=23)
                for r in range(3)]
        its = [c.epoch_batches(0) for c in gen1]
        for r, it in enumerate(its):
            arr = next(it)
            want = np.asarray(spec.with_world(3).rank_indices(
                0, r, layers=layers1))[:23]
            assert np.array_equal(arr, want), f"gen1 rank {r}"
            delivered.append(arr)
        assert gen1[0].reshard(2)["committed"] is False
        for c in gen1:
            c.heartbeat()  # flush delivery acks; the last one commits
        state = json.loads(open(snap_path).read())
        assert state["format"] == 2
        assert [tuple(l) for l in state["layers"]] == [(4, 46), (3, 23)]
        for c in gen1:
            c.close()
        srv.stop()

        srv = IndexServer(spec, host=host, port=port,
                          snapshot_path=snap_path, snapshot_interval=1)
        srv.start()
        layers2 = [(4, 46), (3, 23)]
        gen2 = [ServiceIndexClient((host, port), rank=r, batch=23)
                for r in range(2)]
        try:
            for r, c in enumerate(gen2):
                got = c.epoch_indices(0)
                want = np.asarray(spec.with_world(2).rank_indices(
                    0, r, layers=layers2))
                assert np.array_equal(got, want), f"gen2 rank {r}"
                delivered.append(got)
        finally:
            for c in gen2:
                c.close()
            srv.stop()
    union = np.concatenate(delivered)
    # two committed reshards: each contributes at most its new world's
    # wrap-pad (plain mode: one sample per pad slot)
    assert_union_law(union, ref, new_world=3, max_unit=1, reshards=2)


# ------------------------------------------------------ typed back-pressure
def test_reshard_in_progress_is_a_typed_error():
    """A rank that drained to its barrier target cannot wait forever on
    a straggler: past its retry deadline it surfaces ReshardInProgress
    (a ServiceError with code 'reshard'), not a hang."""
    spec = build_spec("plain", 2)
    with IndexServer(spec) as srv:
        c0 = ServiceIndexClient(srv.address, rank=0, batch=31,
                                backoff_base=0.01, reconnect_timeout=10.0)
        c1 = ServiceIndexClient(srv.address, rank=1, batch=31,
                                backoff_base=0.01, reconnect_timeout=0.6)
        try:
            it0 = c0.epoch_batches(0)
            next(it0)  # the straggler: behind the barrier, never drains
            it1 = c1.epoch_batches(0)
            next(it1)
            next(it1)
            assert c1.reshard(1)["committed"] is False
            t0 = time.monotonic()
            with pytest.raises(ReshardInProgress) as ei:
                next(it1)
            assert time.monotonic() - t0 < 8.0
            assert isinstance(ei.value, ServiceError)
            assert ei.value.code == "reshard"
            assert c1.metrics.report()["counters"].get(
                "reshard_waits", 0) >= 1
        finally:
            c0.close()
            c1.close()


def test_fresh_autoclaim_refuses_partially_served_slot():
    """The double-delivery guard: a displaced client's rank=-1 rejoin
    must not adopt a slot whose current-generation stream was already
    partly served — replaying it from seq 0 would duplicate batches."""
    spec = build_spec("plain", 2)
    with IndexServer(spec) as srv:
        c0 = ServiceIndexClient(srv.address, rank=0, batch=31,
                                backoff_base=0.01, reconnect_timeout=10.0)
        c1 = ServiceIndexClient(srv.address, rank=1, batch=31,
                                backoff_base=0.01, reconnect_timeout=10.0)
        try:
            it0 = c0.epoch_batches(0)
            it1 = c1.epoch_batches(0)
            got0 = [next(it0), next(it0)]
            got1 = [next(it1), next(it1)]
            assert c0.reshard(1)["committed"] is False
            c1.heartbeat()  # c1's delivered ack: its drain completes
            got0.append(next(it0))  # c0's own ack commits; first
            # post-reshard batch arrives through the `resharded` adopt
            c0.close()  # lease freed, but the slot is partly served
            # wait for the server to process c0's disconnect: until the
            # lease release lands, the resharded header c1 is about to
            # draw reflects a still-live slot 0 and the auto-claim path
            # under test never runs
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                with srv._lock:
                    lease = srv._leases.get(0)
                    if lease is None or lease.get("owner") is None:
                        break
                time.sleep(0.01)
            rest1 = list(it1)  # displaced; the only slot is not adoptable
            assert rest1 == []
            assert c1.rank is None
            assert c1.metrics.report()["counters"].get(
                "membership_lost", 0) >= 1
        finally:
            c0.close()
            c1.close()


def test_protocol_version_mismatch_is_refused_with_both_ints():
    spec = build_spec("plain", 1)
    with IndexServer(spec) as srv:
        sock = socket.create_connection(srv.address, timeout=5.0)
        try:
            P.send_msg(sock, P.MSG_HELLO,
                       {"proto": 1, "rank": 0, "batch": 32})
            msg, header, _ = P.recv_msg(sock)
        finally:
            sock.close()
    assert msg == P.MSG_ERROR
    assert header["code"] == "protocol_version"
    assert header["server_proto"] == P.PROTOCOL_VERSION
    assert header["client_proto"] == 1


# ----------------------------------------- barrier/delivery race regressions
def test_freeze_race_does_not_double_serve():
    """A GET_BATCH already past its admission check when the barrier
    freezes must not deliver an unclamped batch beyond the frozen
    watermarks: the counting tail refuses it and the retry is served
    clamped — no span rides both the pre-commit stream and the
    repartitioned remainder."""
    spec = build_spec("plain", 2)
    ref = epoch_union_ref(spec)
    srv = IndexServer(spec)
    srv.start()
    in_window = threading.Event()
    go = threading.Event()
    armed = threading.Event()
    real = srv._rank_array

    def stalled_rank_array(epoch, rank):
        arr = real(epoch, rank)
        if rank == 0 and armed.is_set():
            # hold THIS request between its admission check and its
            # counting tail while the barrier freezes underneath it
            armed.clear()
            in_window.set()
            go.wait(timeout=30.0)
        return arr

    srv._rank_array = stalled_rank_array
    c0 = ServiceIndexClient(srv.address, rank=0, batch=31,
                            backoff_base=0.01, reconnect_timeout=20.0)
    c1 = ServiceIndexClient(srv.address, rank=1, batch=31,
                            backoff_base=0.01, reconnect_timeout=20.0)
    got0, got1 = [], []
    try:
        it0 = c0.epoch_batches(0)
        it1 = c1.epoch_batches(0)
        got0.extend([next(it0), next(it0)])
        got1.append(next(it1))
        armed.set()
        t0 = threading.Thread(target=lambda: got0.extend(it0))
        t0.start()
        assert in_window.wait(timeout=30.0), "race window never opened"
        # barrier freezes at rank 0's watermark 62 while its seq-2
        # request is paused holding an unclamped [62, 93) slice
        assert c1.reshard(1)["committed"] is False
        go.set()
        got1.extend(it1)  # drains rank 1, commits, bows out displaced
        t0.join(timeout=60.0)
        assert not t0.is_alive(), "rank 0 hung riding the freeze race"
        assert c0.generation == 1 and c0.rank == 0
    finally:
        c0.close()
        c1.close()
        srv.stop()
    union = np.concatenate(got0 + got1)
    # 2 -> 1 has no wrap-pad: any double-served span shows as an extra
    assert np.array_equal(np.sort(union), np.sort(ref))


def test_lost_final_drain_reply_stays_resendable():
    """The barrier commits on ACKED delivery: a rank whose final
    pre-barrier reply was lost can resend it after the drain began —
    the un-acked past-target request draws a retryable error, never a
    commit that drops the span."""
    spec = build_spec("plain", 2)
    with IndexServer(spec) as srv:
        c1 = ServiceIndexClient(srv.address, rank=1, batch=31,
                                backoff_base=0.01, reconnect_timeout=10.0)
        sock = socket.create_connection(srv.address, timeout=5.0)
        try:
            P.send_msg(sock, P.MSG_HELLO,
                       {"proto": P.PROTOCOL_VERSION, "rank": 0,
                        "batch": 31})
            msg, header, _ = P.recv_msg(sock)
            assert msg == P.MSG_WELCOME

            def get(seq, ack):
                P.send_msg(sock, P.MSG_GET_BATCH,
                           {"rank": 0, "epoch": 0, "seq": seq,
                            "ack": ack, "gen": 0})
                return P.recv_msg(sock)

            _, h0, p0 = get(0, -1)
            _, h1, p1 = get(1, 0)   # delivered... but imagine it lost
            it1 = c1.epoch_batches(0)
            next(it1), next(it1)
            c1.heartbeat()          # rank 1 acks its full 62: drained
            assert c1.reshard(1)["committed"] is False
            # rank 0 asks past its target WITHOUT acking seq 1: the
            # commit must wait (acked watermark 31 < target 62)
            msg, h, _ = get(2, 0)
            assert msg == P.MSG_ERROR and h["code"] == "reshard"
            assert srv._state_dict()["generation"] == 0
            # the lost reply is resent, bit-identical, mid-drain
            msg, h1b, p1b = get(1, 0)
            assert msg == P.MSG_BATCH and p1b == p1
            # only the ack past the target completes the drain
            msg, h, _ = get(2, 1)
            assert msg == P.MSG_ERROR and h["code"] == "resharded"
            assert srv._state_dict()["generation"] == 1
        finally:
            sock.close()
            c1.close()


def test_restored_drain_times_out_missing_participant(tmp_path):
    """A daemon restarted mid-drain seeds the membership_timeout clock
    for every un-drained participant, so a drain whose leaver never
    reconnects commits (orphaning the remainder) instead of
    deadlocking every survivor forever."""
    spec = build_spec("plain", 2)
    ref = epoch_union_ref(spec)
    snap_path = str(tmp_path / "snap.json")
    srv = IndexServer(spec, snapshot_path=snap_path, snapshot_interval=1)
    host, port = srv.start()
    c0 = ServiceIndexClient((host, port), rank=0, batch=31,
                            backoff_base=0.01, reconnect_timeout=10.0)
    c1 = ServiceIndexClient((host, port), rank=1, batch=31,
                            backoff_base=0.01, reconnect_timeout=10.0)
    clk = FakeClock()
    srv2 = None
    try:
        it0 = c0.epoch_batches(0)
        it1 = c1.epoch_batches(0)
        got0 = [next(it0)]
        got1 = [next(it1), next(it1)]
        assert c0.leave()["reshard"] is True  # no grace bound at all
        srv.stop()  # killed mid-drain; the leaver never comes back
        c0.close()
        srv2 = IndexServer(spec, host=host, port=port,
                           snapshot_path=snap_path, snapshot_interval=1,
                           membership_timeout=5.0, clock=clk)
        srv2.start()
        assert srv2._reshard is not None
        # the survivor already served its full pre-barrier target before
        # the restart; only the delivered ack is outstanding — an idle
        # heartbeat (re-leasing on reconnect) completes its drain
        c1.heartbeat()
        assert srv2._state_dict()["generation"] == 0
        clk.t += 6.0
        srv2._sweep_leases()     # vacancy clock expired: rank 0 is dead
        snap = srv2._state_dict()
        assert snap["generation"] == 1, "restored drain must time out"
        assert snap["orphans"], "dead leaver's remainder must be orphaned"
        got1.extend(it1)         # adopts rank 0: orphan prefix + stream
        union = np.concatenate(got0 + got1)
        assert np.array_equal(np.sort(union), np.sort(ref))
    finally:
        c0.close()
        c1.close()
        srv.stop()
        if srv2 is not None:
            srv2.stop()


def test_trigger_failure_after_freeze_unfreezes(monkeypatch):
    """An exception anywhere between the freeze and the drain flip —
    including the per-rank target computation — resets the in-flight
    reshard instead of leaving the server frozen (every request drawing
    an endless retry) until restart."""
    spec = build_spec("plain", 2)
    with IndexServer(spec) as srv:
        c0 = ServiceIndexClient(srv.address, rank=0, batch=31,
                                backoff_base=0.01, reconnect_timeout=10.0)
        c1 = ServiceIndexClient(srv.address, rank=1, batch=31,
                                backoff_base=0.01, reconnect_timeout=10.0)
        try:
            it0 = c0.epoch_batches(0)
            it1 = c1.epoch_batches(0)
            got0 = [next(it0)]
            got1 = [next(it1)]
            real_inc = srv.metrics.inc

            def boom(name, *a, **kw):
                if name == "reshard_triggers":
                    raise RuntimeError("injected target-computation fault")
                return real_inc(name, *a, **kw)

            monkeypatch.setattr(srv.metrics, "inc", boom)
            with pytest.raises(RuntimeError):
                srv._trigger_reshard(1)
            monkeypatch.setattr(srv.metrics, "inc", real_inc)
            assert srv._reshard is None, "failed trigger left a freeze"
            # not bricked: both streams still serve to their epoch end
            got0.extend(it0)
            got1.extend(it1)
            assert np.array_equal(
                np.concatenate(got0), np.asarray(spec.rank_indices(0, 0)))
            assert np.array_equal(
                np.concatenate(got1), np.asarray(spec.rank_indices(0, 1)))
        finally:
            c0.close()
            c1.close()


# --------------------------------------------- loader ride-through + degraded
def test_loader_rides_through_world_change_and_degraded_composition():
    """HostDataLoader(index_client=..., index_backend=BACKEND, device="cpu") sees one contiguous epoch across
    a server-driven world change; once the daemon dies, the degraded
    fallback recomposes the SAME stream from the adopted membership."""
    spec = build_spec("plain", 2)
    X = np.arange(997, dtype=np.int64)
    srv = IndexServer(spec)
    srv.start()
    c1 = ServiceIndexClient(srv.address, rank=1, batch=31,
                            backoff_base=0.01, reconnect_timeout=10.0)
    c0 = ServiceIndexClient(srv.address, rank=0, batch=31,
                            backoff_base=0.01, reconnect_timeout=0.6)
    loader = HostDataLoader(X, window=64, batch=64, seed=7, rank=0, world=2,
                            index_client=c0, index_backend=BACKEND, device="cpu")
    try:
        it1 = c1.epoch_batches(0)
        got1 = [next(it1), next(it1)]
        assert c1.leave(grace_ms=60_000)["reshard"] is True
        got1.extend(it1)  # leaver drains to its barrier, terminal eof
        # the loader's epoch pull crosses the commit transparently
        live = loader.epoch_indices(0)
        assert c0.generation == 1 and c0.world == 1
        assert not loader.degraded
        expected = np.concatenate([
            np.asarray(spec.rank_indices(0, 0))[:62],
            np.asarray(spec.with_world(1).rank_indices(
                0, 0, layers=[(2, 62)])),
        ])
        assert np.array_equal(live, expected)
        union = np.concatenate(got1 + [live])
        assert np.array_equal(np.sort(union),
                              np.sort(epoch_union_ref(spec)))
        # daemon gone: the degraded composition must reproduce the live
        # elastic stream from the client's membership trail
        srv.stop()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            degraded0 = loader.epoch_indices(0)
            degraded1 = loader.epoch_indices(1)
        assert loader.degraded
        assert np.array_equal(degraded0, live)
        # epochs after the elastic one are plain new-world partitions
        assert np.array_equal(
            degraded1,
            np.asarray(spec.with_world(1).rank_indices(1, 0)))
    finally:
        c0.close()
        c1.close()
        srv.stop()
