"""The port's counterpart of the JAX package's ``tests/test_failover.py``.

Every case runs on ``partiallyshuffledistributedsampler_tpu_torch`` with its
specs and loaders on ``backend="cpu"`` (no card), under the port's
lock-order sanitizer; the JAX file's text follows.

Hot-standby replication: WAL shipping, failover, split-brain fencing.

The acceptance drill (docs/RESILIENCE.md "Replication & failover"): with
a standby attached, ``kill -9`` of the primary mid-epoch costs the
clients a latency blip and nothing else — zero degraded-mode entries,
zero duplicated or dropped samples, the merged stream bit-identical to
an unkilled run — in all three spec modes and across a reshard drain
boundary.  A fenced zombie primary must refuse every state-mutating
request with a typed ``fenced`` error carrying the new term.

Covered here: the kill-mid-epoch matrix over plain/mixture/shard; the
``HostDataLoader`` riding through a failover without a degraded entry;
a primary killed at a reshard drain boundary (union law holds on the
promoted standby); WAL catch-up after the standby joins late; snapshot
CRC refusal of a torn file; and the fencing
semantics of a zombie that survives its own demotion.
"""

from __future__ import annotations

import json
import threading
import time
import warnings

import numpy as np
import pytest

from partiallyshuffledistributedsampler_tpu_torch.sampler.host_loader import (
    HostDataLoader,
)
from partiallyshuffledistributedsampler_tpu_torch.service import (
    IndexServer,
    PartialShuffleSpec,
    ServiceIndexClient,
)
from partiallyshuffledistributedsampler_tpu_torch.service import protocol as P
from partiallyshuffledistributedsampler_tpu_torch.utils.checkpoint import (
    load_sampler_state,
    save_sampler_state,
)

from test_torch_port_elastic_service import (
    MAX_UNIT,
    assert_union_law,
    build_spec,
    epoch_union_ref,
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

pytestmark = pytest.mark.failover


def replicated_pair(spec, feed_timeout=0.25, **primary_kw):
    """A started (primary, standby) pair shipping the WAL over loopback."""
    standby = IndexServer(spec, role="standby", repl_feed_timeout=feed_timeout)
    standby.start()
    primary = IndexServer(spec, standby=standby.address,
                          repl_feed_timeout=feed_timeout, **primary_kw)
    primary.start()
    return primary, standby


def wait_for(cond, timeout=10.0, interval=0.01):
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            raise AssertionError("condition not reached within deadline")
        time.sleep(interval)


def wait_synced(primary, standby, timeout=10.0):
    """Block until the standby has applied everything the log holds."""
    wait_for(lambda: (primary._shipper is not None
                      and primary._shipper.synced.is_set()
                      and standby._applied_lsn >= primary._repl_log.lsn),
             timeout=timeout)


# ---------------------------------------------------- kill-mid-epoch matrix
@pytest.mark.parametrize("mode", ["plain", "mixture", "shard"])
def test_kill_primary_mid_epoch_bit_identical(mode):
    """Both ranks stream a batch, the primary is hard-killed, both finish
    on the promoted standby with streams bit-identical to an unkilled
    run — exactly-once across the failover, no degraded fallback."""
    spec = build_spec(mode, 2)
    primary, standby = replicated_pair(spec)
    delivered = {}
    lock = threading.Lock()
    b_streamed = threading.Barrier(3)
    b_killed = threading.Barrier(3)

    def worker(r):
        got = []
        c = ServiceIndexClient(primary.address, rank=r, batch=23, spec=spec,
                               backoff_base=0.01, reconnect_timeout=2.0)
        try:
            it = c.epoch_batches(0)
            got.append(next(it))
            b_streamed.wait(timeout=30.0)
            b_killed.wait(timeout=30.0)
            for arr in it:
                got.append(arr)
        finally:
            with lock:
                delivered[r] = (got, c.metrics.report()["counters"])
            c.close()

    threads = [threading.Thread(target=worker, args=(r,)) for r in range(2)]
    try:
        for t in threads:
            t.start()
        b_streamed.wait(timeout=30.0)
        wait_synced(primary, standby)
        primary.kill()
        b_killed.wait(timeout=30.0)
        for t in threads:
            t.join(timeout=60.0)
            assert not t.is_alive(), "failover worker hung"
    finally:
        primary.kill()
        standby.stop()
    assert standby.role == "primary", "standby never promoted"
    assert standby.term >= 1
    for r in range(2):
        got, counters = delivered[r]
        ref = np.asarray(spec.rank_indices(0, r))
        assert np.array_equal(np.concatenate(got), ref), (
            f"rank {r} stream diverged across the failover ({mode})")
        assert counters.get("failovers", 0) >= 1
        assert counters.get("degraded_mode", 0) == 0


def test_loader_failover_never_enters_degraded_mode():
    """The HostDataLoader sees the failover only as latency: the dead
    primary is absorbed INSIDE the client, so the loader stays attached
    and its stream bit-matches a purely local loader."""
    X = np.arange(997, dtype=np.int64)
    local = HostDataLoader(X, window=64, batch=64, seed=7, rank=0, world=1, index_backend=BACKEND, device="cpu")
    spec = PartialShuffleSpec.plain(997, window=64, seed=7, world=1, backend=BACKEND)
    primary, standby = replicated_pair(spec)
    client = ServiceIndexClient(primary.address, rank=0, batch=64, spec=spec,
                                backoff_base=0.01, reconnect_timeout=2.0)
    loader = HostDataLoader(X, window=64, batch=64, seed=7, rank=0, world=1,
                            index_client=client, index_backend=BACKEND, device="cpu")
    try:
        assert np.array_equal(loader.epoch_indices(0),
                              local.epoch_indices(0))
        wait_synced(primary, standby)
        primary.kill()
        got = loader.epoch_indices(1)
        assert np.array_equal(got, local.epoch_indices(1))
        assert loader.degraded is False
        counters = client.metrics.report()["counters"]
        assert counters.get("degraded_mode", 0) == 0
        assert counters.get("failovers", 0) >= 1
    finally:
        client.close()
        primary.kill()
        standby.stop()


# ------------------------------------------------- reshard drain boundary
def test_kill_primary_at_drain_boundary_union_law():
    """The primary dies after freezing the drain barrier but before the
    commit: the standby inherits the replicated barrier state, promotes,
    finishes the drain, and the union law still holds."""
    spec = build_spec("plain", 2)
    ref = epoch_union_ref(spec)
    primary, standby = replicated_pair(spec)
    delivered = {}
    lock = threading.Lock()
    b_hit = threading.Barrier(2)
    # THREE parties: both workers AND the main thread — the workers must
    # not resume their streams until the primary is already dead, else a
    # fast drain can complete the whole epoch before the kill lands and
    # the standby is never asked to promote (the race this test means to
    # pin, not dodge)
    b_go = threading.Barrier(3)

    def worker(r):
        got = []
        c = ServiceIndexClient(primary.address, rank=r, batch=23, spec=spec,
                               backoff_base=0.01, reconnect_timeout=3.0)
        try:
            it = c.epoch_batches(0)
            for _ in range(1 + r):
                try:
                    got.append(next(it))
                except StopIteration:
                    break
            b_hit.wait(timeout=30.0)
            if r == 0:
                c.reshard(1)
            b_go.wait(timeout=30.0)
            for arr in it:
                got.append(arr)
        finally:
            with lock:
                delivered[r] = got
            c.close()

    threads = [threading.Thread(target=worker, args=(r,)) for r in range(2)]
    try:
        for t in threads:
            t.start()
        # the drain barrier froze (reshard() returned past b_hit); make
        # sure the standby holds the frozen-barrier WAL record, then
        # kill the primary before the workers resume and commit
        wait_for(lambda: primary._reshard is not None
                 or primary._state_dict()["generation"] >= 1, timeout=30.0)
        wait_synced(primary, standby)
        primary.kill()
        b_go.wait(timeout=30.0)  # release the workers onto the dead primary
        for t in threads:
            t.join(timeout=60.0)
            assert not t.is_alive(), "drain-boundary worker hung"
    finally:
        primary.kill()
        standby.stop()
    assert standby.role == "primary"
    union = np.concatenate(
        [np.concatenate(v) if v else np.empty(0, np.int64)
         for v in delivered.values()])
    assert_union_law(union, ref, new_world=1, max_unit=MAX_UNIT["plain"])


# -------------------------------------------------------- WAL catch-up
def test_standby_resyncs_after_log_tail_rotation():
    """A standby that falls behind the in-memory tail is healed by a
    fresh snapshot SYNC, not fed a gapped stream."""
    spec = PartialShuffleSpec.plain(530, window=32, seed=7, world=1, backend=BACKEND)
    primary, standby = replicated_pair(spec)
    try:
        with ServiceIndexClient(primary.address, rank=0, batch=37, spec=spec,
                                backoff_base=0.01) as c:
            c.epoch_indices(0)
        wait_synced(primary, standby)
        # force a gap: pretend the standby saw a far-future stream, then
        # reset it so the next APPEND's from_lsn looks discontiguous
        with standby._lock:
            standby._applied_lsn = 0
        with ServiceIndexClient(primary.address, rank=0, batch=37, spec=spec,
                                backoff_base=0.01) as c:
            c.epoch_indices(1)
        wait_synced(primary, standby)
        assert standby._applied_lsn == primary._repl_log.lsn
        assert standby._cursors[0]["epoch"] == 1
    finally:
        primary.stop()
        standby.stop()


# --------------------------------------------------- split-brain fencing
def test_zombie_primary_is_fenced_after_promotion():
    """The old primary survives its own demotion: a forced promotion on
    the standby bumps the term, and every write the zombie sees after
    learning of it is refused with a typed ``fenced`` error carrying the
    new term — the zombie's epoch state never mutates."""
    spec = PartialShuffleSpec.plain(530, window=32, seed=7, world=1, backend=BACKEND)
    # huge feed timeout: the standby will NOT self-promote, we force it
    primary, standby = replicated_pair(spec, feed_timeout=60.0)
    import socket as _socket

    def raw_write(addr, header, msg=P.MSG_SET_EPOCH):
        sock = _socket.create_connection(addr, timeout=5.0)
        try:
            P.send_msg(sock, P.MSG_HELLO,
                       {"proto": P.PROTOCOL_VERSION, "rank": 0, "batch": 32})
            m, h, _ = P.recv_msg(sock)
            if m == P.MSG_ERROR:
                return m, h
            P.send_msg(sock, msg, header)
            m, h, _ = P.recv_msg(sock)
            return m, h
        finally:
            sock.close()

    try:
        with ServiceIndexClient(primary.address, rank=0, batch=37,
                                spec=spec, backoff_base=0.01) as c:
            c.epoch_indices(0)
        wait_synced(primary, standby)
        epoch_before = primary.epoch
        assert standby._try_promote(force=True)
        assert standby.term == primary.term + 1
        # a write stamped with the new term reaches the zombie: it must
        # fence itself on the spot and refuse with the typed error
        m, h = raw_write(primary.address,
                         {"epoch": 5, "term": standby.term})
        assert m == P.MSG_ERROR and h["code"] == "fenced"
        assert h["term"] >= standby.term
        assert h["serving"] is False
        # once fenced, even a term-less legacy write is refused
        m, h = raw_write(primary.address, {"epoch": 6})
        assert m == P.MSG_ERROR and h["code"] == "fenced"
        assert h["term"] >= standby.term
        assert primary.epoch == epoch_before, "zombie write mutated state"
        assert primary._fenced_term is not None
        counters = primary.metrics.report()["counters"]
        assert counters.get("fenced_writes", 0) >= 1
    finally:
        primary.stop()
        standby.stop()


def test_fenced_client_fails_over_to_serving_peer():
    """A client talking to the zombie follows the fencing term to the
    promoted standby and keeps streaming — no degraded entry."""
    spec = PartialShuffleSpec.plain(530, window=32, seed=7, world=1, backend=BACKEND)
    primary, standby = replicated_pair(spec, feed_timeout=60.0)
    client = ServiceIndexClient(primary.address, rank=0, batch=37, spec=spec,
                                backoff_base=0.01, reconnect_timeout=2.0)
    try:
        it = client.epoch_batches(0)
        got = [next(it)]
        wait_synced(primary, standby)
        assert standby._try_promote(force=True)
        # fence the zombie out-of-band (the shipper would do this on its
        # next APPEND; do it directly so the test is deterministic)
        primary._fence(standby.term)
        got.extend(it)
        ref = np.asarray(spec.rank_indices(0, 0))
        assert np.array_equal(np.concatenate(got), ref)
        counters = client.metrics.report()["counters"]
        assert counters.get("fenced_replies", 0) >= 1
        assert counters.get("degraded_mode", 0) == 0
        assert client.term >= standby.term
    finally:
        client.close()
        primary.stop()
        standby.stop()


# ----------------------------------------------- snapshot durability (CRC)
def test_snapshot_embeds_crc_and_refuses_torn_file(tmp_path):
    spec = PartialShuffleSpec.plain(530, window=32, seed=7, world=1, backend=BACKEND)
    path = str(tmp_path / "snap.json")
    with IndexServer(spec, snapshot_path=path, snapshot_interval=1) as srv:
        with ServiceIndexClient(srv.address, rank=0, batch=37,
                                spec=spec) as c:
            c.set_epoch(3)
            c.epoch_indices(3)
        srv._write_snapshot(force=True)
    state = load_sampler_state(path)
    assert "crc32" in state
    # clean restart adopts the snapshot
    with IndexServer(spec, snapshot_path=path) as srv2:
        assert srv2.epoch == 3
        assert srv2.metrics.report()["counters"].get("snapshot_corrupt",
                                                     0) == 0
    # tear the payload without touching the recorded CRC
    state["epoch"] = 4
    with open(path, "w") as f:
        json.dump(state, f)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with IndexServer(spec, snapshot_path=path) as srv3:
            assert srv3.epoch == 0, "torn snapshot must not be loaded"
            assert srv3.metrics.report()["counters"].get(
                "snapshot_corrupt", 0) >= 1
    assert any("snapshot" in str(w.message).lower() for w in caught)


def test_save_sampler_state_durable_roundtrip(tmp_path):
    path = str(tmp_path / "s.json")
    save_sampler_state(path, {"a": 1}, durable=True)
    assert load_sampler_state(path) == {"a": 1}
    save_sampler_state(path, {"a": 2}, durable=True)
    assert load_sampler_state(path) == {"a": 2}


# --------------------------------------------------------- wire surface
def test_welcome_advertises_standby_and_term():
    spec = PartialShuffleSpec.plain(530, window=32, seed=7, world=1, backend=BACKEND)
    primary, standby = replicated_pair(spec)
    try:
        with ServiceIndexClient(primary.address, rank=0, batch=37,
                                spec=spec) as c:
            c.heartbeat()
            assert c.standby_address == standby.address
            assert c.term == primary.term
    finally:
        primary.stop()
        standby.stop()


def test_standby_refuses_client_writes_while_feed_is_fresh():
    spec = PartialShuffleSpec.plain(530, window=32, seed=7, world=1, backend=BACKEND)
    primary, standby = replicated_pair(spec, feed_timeout=60.0)
    try:
        wait_synced(primary, standby)
        import socket as _socket
        sock = _socket.create_connection(standby.address, timeout=5.0)
        try:
            P.send_msg(sock, P.MSG_HELLO,
                       {"proto": P.PROTOCOL_VERSION, "rank": 0, "batch": 32})
            msg, header, _ = P.recv_msg(sock)
        finally:
            sock.close()
        assert msg == P.MSG_ERROR
        assert header["code"] == "standby"
        assert tuple(header["primary"]) == primary.address
    finally:
        primary.stop()
        standby.stop()
