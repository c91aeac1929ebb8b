"""The port's counterpart of the JAX package's ``tests/test_sharding.py``.

Every case runs on ``partiallyshuffledistributedsampler_tpu_torch`` with its
specs on ``backend="cpu"`` (no card), under the port's lock-order
sanitizer; the cross-package checks at the end hold the port against the
JAX package.  The JAX file's text follows.

Scale-out serving plane: shards behind the rank-space router.

The acceptance law (docs/SHARDING.md): sharding is a *deployment* choice,
never a semantics change — the per-rank streams served by an N-shard
plane are bit-identical to a single ``IndexServer``'s in every spec
mode, including across a shard failover and a cross-shard reshard
barrier, and the router is never on the data path (a direct-connected
client keeps streaming while the router is down).

Covered here: ``ShardMap`` derivation/lookup/wire laws; the 3-shard ×
plain/mixture/shard bit-identity matrix (folded and per-rank); the
``wrong_shard`` redirect without a router round-trip; kill-one-shard
with standby promotion (union law, zero dup/lost); the two-phase
cross-shard reshard barrier with rank migration between shards; a
router restart mid-epoch (direct clients unaffected, new clients
block-and-retry, the map version survives via the router's snapshot);
and tenant attach across shards.
"""

from __future__ import annotations

import json
import signal
import threading
import time

import numpy as np
import pytest

from partiallyshuffledistributedsampler_tpu_torch.service import (
    IndexServer,
    ServiceError,
    ServiceIndexClient,
)
from partiallyshuffledistributedsampler_tpu_torch.service import protocol as P
from partiallyshuffledistributedsampler_tpu_torch.sharding import (
    ShardMap,
    ShardPlane,
    ShardRouter,
)

from test_torch_port_elastic_service import (
    MAX_UNIT,
    assert_union_law,
    build_spec,
    epoch_union_ref,
)
from test_torch_port_failover import wait_for, wait_synced

from partiallyshuffledistributedsampler_tpu_torch.analysis import lockorder
from partiallyshuffledistributedsampler_tpu_torch.service import (
    PartialShuffleSpec,
)
from partiallyshuffledistributedsampler_tpu import service as JS
from partiallyshuffledistributedsampler_tpu import sharding as JSH

from test_elastic_service import build_spec as jax_build_spec

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


pytestmark = pytest.mark.sharding


def _stream(addr, rank, spec=None, **kw):
    kw.setdefault("batch", 23)
    kw.setdefault("backoff_base", 0.01)
    with ServiceIndexClient(addr, rank=rank, spec=spec, **kw) as c:
        got = list(c.epoch_batches(0))
    return (np.concatenate(got) if got else np.empty(0, np.int64))


# ------------------------------------------------------------- ShardMap
def test_shardmap_canonical_partition_and_lookup():
    m = ShardMap.for_world(10, 3)
    assert m.slices == ((0, 3), (3, 6), (6, 10))
    assert [m.owner(r) for r in range(10)] == \
        [0, 0, 0, 1, 1, 1, 2, 2, 2, 2]
    assert m.owns(1, 4) and not m.owns(1, 6)
    with pytest.raises(ValueError):
        m.owner(10)
    # more shards than ranks: tail shards own empty slices, every rank
    # still has exactly one owner
    small = ShardMap.for_world(2, 4)
    assert {small.owner(0), small.owner(1)} <= set(range(4))
    assert sum(hi - lo for lo, hi in small.slices) == 2


def test_shardmap_rejects_non_contiguous_cover():
    with pytest.raises(ValueError):
        ShardMap(6, [(0, 2), (3, 6)])      # gap
    with pytest.raises(ValueError):
        ShardMap(6, [(0, 4), (2, 6)])      # overlap
    with pytest.raises(ValueError):
        ShardMap(6, [(0, 2), (2, 4)])      # short cover


def test_shardmap_wire_roundtrip_and_versioning():
    m = ShardMap.for_world(7, 3)
    m.set_addr(1, ("127.0.0.1", 4242))
    m2 = ShardMap.from_wire(m.to_wire())
    assert m2 == m and m2.fingerprint() == m.fingerprint()
    reb = m.rebalanced(5)
    assert reb.version == m.version + 1
    assert reb.world == 5 and reb.n_shards == m.n_shards
    assert reb.addr(1) == ("127.0.0.1", 4242)
    assert reb.fingerprint() != m.fingerprint()


# ---------------------------------------------- 3-shard bit-identity matrix
@pytest.mark.parametrize("mode", ["plain", "mixture", "shard"])
def test_three_shard_streams_bit_identical_to_single_server(mode):
    """Every rank dials the ROUTER, is redirected to its shard, and
    streams exactly what a single ``IndexServer`` serves it — per rank
    and folded — in all three spec modes."""
    spec = build_spec(mode, 6)
    with IndexServer(spec) as srv:
        ref = {r: _stream(srv.address, r) for r in range(6)}
    with ShardPlane(spec, 3) as plane:
        got = {}
        for r in range(6):
            with ServiceIndexClient(plane.address, rank=r, batch=23,
                                    backoff_base=0.01) as c:
                arrs = list(c.epoch_batches(0))
                got[r] = np.concatenate(arrs)
                # the client ended up direct-connected to its shard, map
                # in hand — never streaming through the router
                assert c.shard_map is not None
                assert c.address != plane.router.address
    for r in range(6):
        assert np.array_equal(got[r], ref[r]), (
            f"rank {r} diverged from the single-server stream ({mode})")
    folded = np.concatenate([got[r] for r in range(6)])
    assert np.array_equal(folded, epoch_union_ref(spec)), (
        f"folded 3-shard stream diverged ({mode})")


def test_wrong_shard_redirect_without_router():
    """A client pointed at the WRONG shard is redirected by the typed
    ``wrong_shard`` refusal alone — the attached map re-routes it with
    no router round-trip, and the stream is exact."""
    spec = build_spec("plain", 6)
    with ShardPlane(spec, 3) as plane:
        wrong = plane.shards[0].address     # shard 0 does not own rank 5
        with ServiceIndexClient(wrong, rank=5, batch=23,
                                backoff_base=0.01) as c:
            got = np.concatenate(list(c.epoch_batches(0)))
            counters = c.metrics.report()["counters"]
        assert counters.get("wrong_shard_redirects", 0) >= 1
        srv_counters = plane.shards[0].metrics.report()["counters"]
        assert srv_counters.get("wrong_shard_hellos", 0) >= 1
    assert np.array_equal(got, np.asarray(spec.rank_indices(0, 5)))


# ----------------------------------------------------- kill-one-shard drill
def test_kill_one_shard_standby_promotes_union_law():
    """One shard's primary is hard-killed mid-epoch: its ranks finish on
    the promoted standby, the other shards never notice, and the folded
    stream is bit-identical (zero duplicated or lost samples)."""
    spec = build_spec("plain", 6)
    delivered = {}
    lock = threading.Lock()
    b_streamed = threading.Barrier(7)
    b_killed = threading.Barrier(7)
    with ShardPlane(spec, 3, standby=True) as plane:
        victim = plane.shards[1]            # owns ranks [2, 4)
        victim_sb = plane.standbys[1]

        def worker(r):
            got = []
            c = ServiceIndexClient(plane.address, rank=r, batch=23,
                                   backoff_base=0.01,
                                   reconnect_timeout=10.0)
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

        threads = [threading.Thread(target=worker, args=(r,))
                   for r in range(6)]
        for t in threads:
            t.start()
        b_streamed.wait(timeout=30.0)
        wait_synced(victim, victim_sb)
        victim.kill()
        b_killed.wait(timeout=30.0)
        for t in threads:
            t.join(timeout=60.0)
            assert not t.is_alive(), "sharded failover worker hung"
        assert victim_sb.role == "primary", "shard standby never promoted"
    for r in range(6):
        got, counters = delivered[r]
        assert np.array_equal(np.concatenate(got),
                              np.asarray(spec.rank_indices(0, r))), (
            f"rank {r} stream diverged across the shard failover")
        assert counters.get("degraded_mode", 0) == 0
        if r in (2, 3):
            assert counters.get("failovers", 0) >= 1
        else:
            # sibling shards never noticed
            assert counters.get("failovers", 0) == 0


# ------------------------------------------- cross-shard reshard barrier
def test_cross_shard_reshard_barrier_union_law():
    """World 6 -> 4 across three shards mid-epoch, through the router's
    two-phase barrier: every shard freezes, drains to ONE global unit
    barrier and commits with the v2 map — the union of pre-barrier and
    post-barrier deliveries obeys the exactly-once law, and a rank whose
    owner changed re-routes via ``wrong_shard`` and keeps streaming.  A
    client shrunk out of the world that rejoins takes no survivor's
    slot."""
    spec = build_spec("plain", 6)
    ref = epoch_union_ref(spec)
    delivered = {}
    lock = threading.Lock()
    b_hit = threading.Barrier(7)
    b_go = threading.Barrier(7)
    with ShardPlane(spec, 3) as plane:

        def worker(r):
            got = []
            c = ServiceIndexClient(plane.address, rank=r, batch=23,
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
                b_go.wait(timeout=30.0)
                for arr in it:
                    got.append(arr)
            finally:
                with lock:
                    delivered[r] = (got, c.metrics.report()["counters"])
                c.close()

        threads = [threading.Thread(target=worker, args=(r,))
                   for r in range(6)]
        for t in threads:
            t.start()
        b_hit.wait(timeout=30.0)
        barrier_err = []

        def run_barrier():
            try:
                plane.router.reshard(4)
            except Exception as exc:  # surfaced to the main thread below
                barrier_err.append(exc)

        barrier_thread = threading.Thread(target=run_barrier)
        barrier_thread.start()
        # release the workers only once every shard is actually frozen,
        # so the barrier genuinely lands MID-epoch (not after it)
        wait_for(lambda: all(s._reshard is not None for s in plane.shards),
                 timeout=10.0)
        b_go.wait(timeout=30.0)
        for t in threads:
            t.join(timeout=60.0)
            assert not t.is_alive(), "cross-shard reshard worker hung"
        barrier_thread.join(timeout=60.0)
        assert not barrier_thread.is_alive(), "router barrier hung"
        assert not barrier_err, f"router barrier failed: {barrier_err!r}"
        # every shard committed the same cascade and adopted the v2 map
        for srv in plane.shards:
            assert srv.spec.world == 4
            assert srv.generation == 1
            assert srv.shard_map.version == 2
        layers = {tuple(map(tuple, srv._state_dict()["layers"]))
                  for srv in plane.shards}
        assert len(layers) == 1, (
            f"shards committed diverging cascades: {layers}")
        # a client shrunk out of the world rejoins with rank=-1 (what a
        # ``resharded`` reply listing a vacated slot makes it do): every
        # survivor finished and freed its slot, and no shard may hand it
        # one, or that survivor's remainder is served a second time
        for srv in plane.shards:
            late = ServiceIndexClient(srv.address, rank=None, batch=23,
                                      backoff_base=0.01,
                                      reconnect_timeout=1.0)
            try:
                with pytest.raises(ServiceError) as refused:
                    late.heartbeat()
                assert refused.value.code == "no_rank"
            finally:
                late.close()
    union = np.concatenate(
        [np.concatenate(v) if v else np.empty(0, np.int64)
         for v, _ in delivered.values()])
    assert_union_law(union, ref, new_world=4, max_unit=MAX_UNIT["plain"])
    # rank 3's owner moved (shard 1 [2,4) -> shard 2 [3,4)): it must
    # have ridden a wrong_shard redirect, not ended early
    assert delivered[3][1].get("wrong_shard_redirects", 0) >= 1


# ------------------------------------------------- router restart drill
def test_router_restart_mid_epoch():
    """The router is a control-plane-only process: killing it mid-epoch
    leaves every direct-connected client streaming; a NEW client blocks
    and retries until the router returns on the same port; the restarted
    router recovers the CURRENT map version from its own snapshot."""
    spec = build_spec("plain", 6)
    with _plane_with_snapshots(spec) as (plane, snap):
        # bump the map version first so the snapshot carries v2; streams
        # now follow the committed post-reshard cascade at world 4
        plane.router.reshard(4)
        assert plane.router._map.version == 2
        layers = plane.shards[0]._state_dict()["layers"]
        new_spec = spec.with_world(4)
        router_addr = plane.router.address
        with ServiceIndexClient(plane.address, rank=0, batch=23,
                                backoff_base=0.01) as c:
            it = c.epoch_batches(0)
            first = next(it)
            plane.router.stop()             # snapshot written on the way out
            rest = list(it)                 # direct-connected: unaffected
            got = np.concatenate([first] + rest)
        assert np.array_equal(
            got, np.asarray(new_spec.rank_indices(0, 0, layers=layers)))

        # a new client dialing the dead router blocks and retries...
        late = {}

        def late_client():
            # lazy connect: the first request rides the retry layer, so
            # the dead router reads as "keep knocking", not a hard fail
            c = ServiceIndexClient(router_addr, rank=1, batch=23,
                                   backoff_base=0.05,
                                   reconnect_timeout=20.0)
            try:
                late["got"] = np.concatenate(list(c.epoch_batches(0)))
            finally:
                c.close()

        t = threading.Thread(target=late_client)
        t.start()
        time.sleep(0.3)
        assert t.is_alive(), "new client gave up instead of retrying"
        # ...until the router returns on the same port, from a STALE
        # constructor map — the snapshot must restore v2
        stale = ShardMap.for_world(6, 3)
        router2 = ShardRouter(spec, stale, "127.0.0.1", router_addr[1],
                              snapshot_path=snap)
        try:
            router2.start()
            assert router2._map.version == 2, (
                "map version lost across the router restart")
            assert router2._map.world == 4
            t.join(timeout=30.0)
            assert not t.is_alive(), "late client never completed"
        finally:
            router2.stop()
    assert np.array_equal(
        late["got"], np.asarray(new_spec.rank_indices(0, 1, layers=layers)))


class _plane_with_snapshots:
    """A started 3-shard plane with a tmp snapshot dir, yielding
    ``(plane, router_snapshot_path)``."""

    def __init__(self, spec):
        import tempfile
        self._tmp = tempfile.TemporaryDirectory(prefix="psds-sharding-")
        self.plane = ShardPlane(spec, 3, snapshot_dir=self._tmp.name)

    def __enter__(self):
        self.plane.start()
        import os
        return self.plane, os.path.join(self._tmp.name, "router.json")

    def __exit__(self, *exc):
        self.plane.stop()
        self._tmp.cleanup()


# ---------------------------------------------------------------- tenancy
def test_attach_tenant_across_shards():
    """``attach_tenant`` admits a namespace on every owning shard without
    claiming any rank lease; tenant clients then stream bit-identically
    through the plane."""
    spec = build_spec("plain", 6)
    other = build_spec("shard", 6)
    with ShardPlane(spec, 3, multi_tenant=True) as plane:
        attached = plane.router.attach_tenant(other)
        assert attached == [0, 1, 2]
        for r in (0, 5):
            got = _stream(plane.address, r, spec=other,
                          reconnect_timeout=10.0)
            assert np.array_equal(
                got, np.asarray(other.rank_indices(0, r))), (
                f"tenant rank {r} diverged through the sharded plane")


# ------------------------------------------------- across the two packages
def _maps(m):
    """A map and the maps every transform of it gives."""
    out = [m, m.rebalanced(max(1, m.world - 2)), m.rebalanced(m.world + 3)]
    size = [hi - lo for lo, hi in m.slices]
    big = max(range(m.n_shards), key=size.__getitem__)
    if size[big] >= 2:
        out.append(m.split(big))
    if m.n_shards >= 2:
        out.append(m.merged(0, 1))
        if size[0] >= 2:
            out.append(m.migrated(0, 1, 1))
    return out


@pytest.mark.parametrize("world,n_shards", [(10, 3), (2, 4), (7, 3),
                                            (256, 4), (6, 1)])
def test_shardmap_wire_and_fingerprint_equal_across_packages(world,
                                                             n_shards):
    """``to_wire``, ``from_wire`` and ``fingerprint`` of every map and
    of every transform of it are byte-equal across the packages, and
    each package reads the other's wire back to an equal map."""
    m, jm = ShardMap.for_world(world, n_shards), \
        JSH.ShardMap.for_world(world, n_shards)
    for i in range(min(2, n_shards)):
        m.set_addr(i, ("127.0.0.1", 4242 + i))
        jm.set_addr(i, ("127.0.0.1", 4242 + i))
    for a, b in zip(_maps(m), _maps(jm)):
        assert json.dumps(a.to_wire(), sort_keys=True) == \
            json.dumps(b.to_wire(), sort_keys=True)
        assert a.to_wire() == b.to_wire()
        assert a.fingerprint() == b.fingerprint()
        assert [a.owner(r) for r in range(a.world)] == \
            [b.owner(r) for r in range(b.world)]
        assert ShardMap.from_wire(b.to_wire()) == a
        assert JSH.ShardMap.from_wire(a.to_wire()) == b
    for a, b in zip(_maps(m)[3:], _maps(jm)[3:]):
        assert m.moved_spans(a) == jm.moved_spans(b)


def _stream_of(client_cls, addr, rank, **kw):
    with client_cls(addr, rank=rank, batch=23, backoff_base=0.01,
                    **kw) as c:
        got = list(c.epoch_batches(0))
    return np.concatenate(got) if got else np.empty(0, np.int64)


@pytest.mark.parametrize("backend", ["cpu", "native"])
@pytest.mark.parametrize("mode", ["plain", "mixture", "shard"])
def test_three_shard_plane_equals_jax_plane_every_rank(mode, backend):
    """The port's 3-shard plane (specs on ``backend``) serves every rank
    what one port server serves it and what the JAX package's 3-shard
    plane serves it, through each plane's router."""
    jspec = jax_build_spec(mode, 6)
    spec = PartialShuffleSpec.from_wire(jspec.to_wire(), backend=backend)
    assert spec.backend == backend
    with JSH.ShardPlane(jspec, 3) as jplane:
        ref = {r: _stream_of(JS.ServiceIndexClient, jplane.address, r)
               for r in range(6)}
    with IndexServer(spec) as srv:
        single = {r: _stream_of(ServiceIndexClient, srv.address, r)
                  for r in range(6)}
    with ShardPlane(spec, 3) as plane:
        got = {r: _stream_of(ServiceIndexClient, plane.address, r)
               for r in range(6)}
    for r in range(6):
        assert got[r].size > 0
        assert np.array_equal(got[r], ref[r]), (
            f"rank {r} diverged from the JAX plane ({mode}, {backend})")
        assert np.array_equal(got[r], single[r])


def test_clients_cross_the_packages_through_the_router():
    """A JAX client dials the port's router and a port client the JAX
    package's: each is redirected by the other package's map and
    streams exactly (the WELCOME map and ``wrong_shard`` are one wire)."""
    jspec = jax_build_spec("plain", 6)
    spec = PartialShuffleSpec.from_wire(jspec.to_wire(), backend=BACKEND)
    ref = np.asarray(spec.rank_indices(0, 5))
    with ShardPlane(spec, 3) as plane:
        with JS.ServiceIndexClient(plane.router.address, rank=5, batch=23,
                                   backoff_base=0.01) as c:
            a = np.concatenate(list(c.epoch_batches(0)))
            assert c.shard_map is not None
            assert c.address == plane.shards[2].address
    with JSH.ShardPlane(jspec, 3) as jplane:
        b = _stream_of(ServiceIndexClient, jplane.shards[0].address, 5)
    assert np.array_equal(a, ref) and np.array_equal(b, ref)


def test_shard_wal_dirs_are_suffixed_per_shard(tmp_path):
    """Each shard (and its standby) writes its own ``wal_dir/<id>``, as
    the JAX package's plane lays them out."""
    spec = build_spec("plain", 6)
    wal = tmp_path / "wal"
    with ShardPlane(spec, 3, standby=True, wal_dir=str(wal)) as plane:
        _stream(plane.address, 4)
        dirs = sorted(p.name for p in wal.iterdir())
    jwal = tmp_path / "jwal"
    with JSH.ShardPlane(jax_build_spec("plain", 6), 3, standby=True,
                        wal_dir=str(jwal)):
        pass
    assert dirs == sorted(p.name for p in jwal.iterdir())
    assert len(dirs) >= 3
