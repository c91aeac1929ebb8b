"""The wire between the packages: the port's ``service/protocol.py``
frames every message type byte for byte as the JAX package's does, a live
session of either package puts the same frames on the wire in the same
order, and a client of either package streams the same bytes from a
server of the other (plain, mixture, shard and sampling specs; the port's
specs on ``backend="cpu"``), and a scripted mid-epoch reshard delivers the
same bytes to every rank from a daemon of either package.  Tolerance 0
throughout."""

import json
import socket
import struct
import threading
import time

import numpy as np
import pytest

from partiallyshuffledistributedsampler_tpu import service as JS
from partiallyshuffledistributedsampler_tpu.ops.mixture import (
    MixtureSpec as JMixtureSpec,
)
from partiallyshuffledistributedsampler_tpu.sampling import (
    SamplingSpec as JSamplingSpec,
)
from partiallyshuffledistributedsampler_tpu.service import protocol as JP
from partiallyshuffledistributedsampler_tpu.streaming import (
    StreamSpec as JStreamSpec,
)
from partiallyshuffledistributedsampler_tpu_torch import service as PS
from partiallyshuffledistributedsampler_tpu_torch.analysis import lockorder
from partiallyshuffledistributedsampler_tpu_torch.ops.mixture import (
    MixtureSpec as PMixtureSpec,
)
from partiallyshuffledistributedsampler_tpu_torch.sampling import (
    SamplingSpec as PSamplingSpec,
)
from partiallyshuffledistributedsampler_tpu_torch.service import (
    protocol as PP,
)
from partiallyshuffledistributedsampler_tpu_torch.streaming import (
    StreamSpec as PStreamSpec,
)

SECRET = b"psds-test-deployment-secret"
MSG_NAMES = sorted(k for k in vars(JP) if k.startswith("MSG_"))


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


def spec_pair(kind, world=2):
    """The same stream as a JAX spec and a port spec on 'cpu'."""
    if kind == "plain":
        return (JS.PartialShuffleSpec.plain(997, window=64, seed=7,
                                            world=world),
                PS.PartialShuffleSpec.plain(997, window=64, seed=7,
                                            world=world, backend="cpu"))
    if kind == "mixture":
        args = ([400, 300, 200], [5, 3, 2])
        return (JS.PartialShuffleSpec.mixture(
                    JMixtureSpec(*args, windows=32), seed=7, world=world,
                    epoch_samples=600),
                PS.PartialShuffleSpec.mixture(
                    PMixtureSpec(*args, windows=32), seed=7, world=world,
                    epoch_samples=600, backend="cpu"))
    if kind == "shard":
        sizes = [13, 7, 29, 17, 11, 23, 5, 19, 31, 37, 3, 41]
        return (JS.PartialShuffleSpec.shard(sizes, window=4, seed=7,
                                            world=world),
                PS.PartialShuffleSpec.shard(sizes, window=4, seed=7,
                                            world=world, backend="cpu"))
    args = ((900, 600, 500), (5, 1, 2))
    kw = dict(epoch_samples=1024, window=64, seed=11, world=world)
    return (JSamplingSpec.weighted(*args, **kw),
            PSamplingSpec.weighted(*args, backend="cpu", **kw))


# ---------------------------------------------------------------- framing
def test_message_ids_version_and_limits_are_the_jax_packages():
    assert MSG_NAMES == sorted(k for k in vars(PP) if k.startswith("MSG_"))
    for name in MSG_NAMES:
        assert getattr(PP, name) == getattr(JP, name), name
        assert PP.msg_name(getattr(PP, name)) == JP.msg_name(
            getattr(JP, name))
    assert PP.PROTOCOL_VERSION == JP.PROTOCOL_VERSION == 2
    assert PP.MAX_FRAME == JP.MAX_FRAME
    assert PP.msg_name(99) == JP.msg_name(99)


@pytest.mark.parametrize("name", MSG_NAMES)
def test_every_message_type_frames_byte_equal(name):
    rng = np.random.default_rng(len(name))
    header = {"rank": int(rng.integers(0, 256)), "epoch": 3, "seq": 17,
              "gen": 1, "note": "é ✓", "nested": {"a": [1, 2.5, None, True]},
              "layers": [[8, 160_000]]}
    payload = rng.integers(0, 256, 37, dtype=np.uint8).tobytes()
    msg = getattr(JP, name)
    assert PP.pack(msg, header, payload) == JP.pack(msg, header, payload)
    assert PP.pack(msg, {}) == JP.pack(msg, {})
    msgs = [(msg, header, payload), (JP.MSG_OK, {"ok": 1})]
    wires = []
    for mod in (JP, PP):
        a, b = socket.socketpair()
        try:
            mod.send_msgs(a, msgs)
            mod.send_msg(a, msg, header, payload)
            a.shutdown(socket.SHUT_WR)
            wires.append(b"".join(iter(lambda: b.recv(1 << 16), b"")))
        finally:
            a.close()
            b.close()
    assert wires[0] == wires[1]


@pytest.mark.parametrize("send,recv", [(JP, PP), (PP, JP)])
def test_frames_decode_across_the_packages(send, recv):
    arr = np.random.default_rng(3).integers(0, 1 << 40, 500)
    a, b = socket.socketpair()
    try:
        fields, payload = send.encode_indices(arr)
        send.send_msg(a, send.MSG_BATCH, dict(fields, seq=4), payload)
        msg, header, got = recv.recv_msg(b)
        assert msg == recv.MSG_BATCH and header["seq"] == 4
        assert np.array_equal(recv.decode_indices(header, got), arr)
        a.sendall((1 << 30).to_bytes(4, "big"))
        with pytest.raises(recv.ProtocolError):
            recv.recv_msg(b)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("dtype", ["<i4", "<i8", ">i8", "<u4"])
def test_index_codec_byte_equal(dtype):
    arr = np.random.default_rng(5).integers(0, 1 << 30, 257).astype(dtype)
    for a in (arr, arr[::3], arr[:0]):
        jh, jp = JP.encode_indices(a)
        ph, pp = PP.encode_indices(a)
        assert jh == ph and jp == pp
        for dec in (JP.decode_indices, PP.decode_indices):
            out = dec(ph, pp)
            assert out.dtype == a.dtype and np.array_equal(out, a)
    h, p = PP.encode_indices(arr)
    torn = bytearray(p)
    torn[5] ^= 0xFF
    for mod in (JP, PP):
        with pytest.raises(mod.ChecksumError):
            mod.decode_indices(h, bytes(torn))
        with pytest.raises(mod.ProtocolError):
            mod.decode_indices(dict(h, count=3), p)


# ------------------------------------------------------- a live session
def _header(frame: bytes) -> dict:
    (hlen,) = struct.unpack("!I", frame[5:9])
    return json.loads(frame[9:9 + hlen])


def _recorded(P, fn):
    """The frames ``fn`` puts on the wire through protocol module ``P``
    (both sides of a loopback session pack through it)."""
    frames = []
    real = P.pack

    def pack(msg, header, payload=b""):
        out = real(msg, header, payload)
        frames.append((msg, out))
        return out

    P.pack = pack
    try:
        fn()
    finally:
        P.pack = real
    return frames


def _session(S, spec, stream_spec):
    """One client through most of the protocol, request after request
    (lookahead 1: no pipelining, so the frame order is fixed)."""
    with S.IndexServer(spec, capability_secret=SECRET) as srv:
        with S.ServiceIndexClient(srv.address, rank=0, batch=100, spec=spec,
                                  capability_secret=SECRET,
                                  lookahead=1) as c:
            c.epoch_indices(0)
            c.heartbeat()
            c.capability_epoch_indices(1)
            c.set_epoch(2)
            c.snapshot()
            c.server_metrics()
            c.trace_dump()
            with pytest.raises(S.ServiceError, match="no_rank"):
                S.ServiceIndexClient(srv.address, rank=7, batch=100,
                                     reconnect_timeout=0.5).heartbeat()
            c.reshard(1)
            c.leave(grace_ms=0)
    with S.IndexServer(stream_spec) as srv:
        with S.ServiceIndexClient(srv.address, rank=None, batch=4,
                                  attach=True) as f:
            f.append(40)


def test_a_session_puts_the_same_frames_on_the_wire(monkeypatch):
    """Every frame of the same request sequence is byte-equal, in order;
    the metrics report differs only in its measured times."""
    # an APPEND names its feeder by the process's feeder count, which
    # earlier tests in this process moved: both packages' start at 0
    monkeypatch.setattr(JS.client, "_FEEDER_SEQ", 0)
    monkeypatch.setattr(PS.client, "_FEEDER_SEQ", 0)
    j_spec, p_spec = spec_pair("plain")
    jf = _recorded(JP, lambda: _session(
        JS, j_spec, JStreamSpec.plain_stream(64, window=8, seed=7)))
    pf = _recorded(PP, lambda: _session(
        PS, p_spec, PStreamSpec.plain_stream(64, window=8, seed=7,
                                             backend="cpu")))
    assert [m for m, _ in jf] == [m for m, _ in pf]
    seen = {JP.msg_name(m) for m, _ in jf}
    assert seen >= {"HELLO", "WELCOME", "GET_BATCH", "BATCH", "HEARTBEAT",
                    "OK", "GET_CAPABILITY", "CAPABILITY", "SET_EPOCH",
                    "SNAPSHOT", "SNAPSHOT_STATE", "METRICS",
                    "METRICS_REPORT", "TRACE_DUMP", "TRACE_REPORT", "ERROR",
                    "RESHARD", "LEAVE", "APPEND"}
    for (m, jb), (_, pb) in zip(jf, pf):
        if m == JP.MSG_METRICS_REPORT:
            jr, pr = (_header(b)["report"] for b in (jb, pb))
            assert jr["counters"] == pr["counters"]
            assert jr.keys() == pr.keys()
        else:
            assert jb == pb, JP.msg_name(m)


def test_replication_frames_carry_the_same_records():
    """A primary ships its WAL to a standby: the REPL_SYNC snapshot (but
    the primary's own address) and the records of the REPL_APPEND frames
    are the JAX package's (how the records split across frames depends on
    timing)."""

    def run(S):
        spec = spec_pair("plain")[S is PS]
        standby = S.IndexServer(spec, role="standby", repl_feed_timeout=0.25)
        standby.start()
        primary = S.IndexServer(spec, standby=standby.address,
                                repl_feed_timeout=0.25)
        primary.start()

        def synced():
            deadline = time.monotonic() + 10.0
            while not (primary._shipper is not None
                       and primary._shipper.synced.is_set()
                       and standby._applied_lsn >= primary._repl_log.lsn):
                assert time.monotonic() < deadline, "standby never synced"
                time.sleep(0.01)

        try:
            synced()
            with S.ServiceIndexClient(primary.address, rank=0, batch=100,
                                      spec=spec, lookahead=1) as c:
                c.epoch_indices(0)
            synced()
        finally:
            primary.kill()
            standby.stop()

    out = []
    for S, P in ((JS, JP), (PS, PP)):
        frames = _recorded(P, lambda: run(S))
        syncs, records = [], {}
        for m, b in frames:
            header = _header(b)
            # the JAX package frames the port's header to the same bytes
            assert JP.pack(m, header, b[9 + len(json.dumps(
                header, separators=(",", ":")).encode()):]) == b
            if m == P.MSG_REPL_SYNC:
                header["state"].pop("primary_addr")  # a port of this run
                syncs.append(header)
            elif m == P.MSG_REPL_APPEND:
                for rec in header["records"]:
                    records[rec["lsn"]] = rec
        out.append((syncs, records))
    assert out[0][0] == out[1][0] and out[0][0]
    assert out[0][1] == out[1][1] and out[0][1]


# ---------------------------------------------------- across the packages
def _stream(S, address, rank, spec=None, **kw):
    with S.ServiceIndexClient(address, rank=rank, batch=37, spec=spec,
                              **kw) as c:
        return c.epoch_indices(1)


@pytest.mark.parametrize("kind", ["plain", "mixture", "shard", "sampling"])
@pytest.mark.parametrize("direction", ["jax_client_port_server",
                                       "port_client_jax_server"])
def test_delivery_across_the_packages(kind, direction):
    """Each rank's stream, a client of one package against a server of
    the other, is the bytes both packages' specs give."""
    j_spec, p_spec = spec_pair(kind)
    server_spec, C, client_spec = (
        (p_spec, JS, j_spec) if direction == "jax_client_port_server"
        else (j_spec, PS, p_spec))
    S = PS if server_spec is p_spec else JS
    got, errors = {}, []
    with S.IndexServer(server_spec) as srv:

        def client(r):
            try:
                got[r] = _stream(C, srv.address, r, spec=client_spec)
            except BaseException as exc:  # reported below
                errors.append(exc)

        threads = [threading.Thread(target=client, args=(r,))
                   for r in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    assert not errors, errors
    for r in range(2):
        want = np.asarray(j_spec.rank_indices(1, r))
        assert np.array_equal(got[r], want) and got[r].dtype == want.dtype
        assert np.array_equal(p_spec.rank_indices(1, r), want)


def _scripted_reshard(S, spec, new_world):
    """Old rank ``r`` takes ``1 + r`` batches request-reply (so each
    watermark is exactly what it took), rank 0 asks for ``new_world``,
    and every rank streams to its end; joiners dial once the barrier has
    committed.  Returns the committed layers and the delivered streams:
    old ranks by their rank, joiners by the rank they were given."""
    old_world = spec.world
    delivered, errors = {}, []
    hit, go = threading.Barrier(old_world), threading.Barrier(old_world)
    kw = dict(batch=7, lookahead=1, backoff_base=0.01,
              reconnect_timeout=20.0)
    with S.IndexServer(spec) as srv:

        def old_rank(r):
            with S.ServiceIndexClient(srv.address, rank=r, **kw) as c:
                it = c.epoch_batches(1)
                got = [next(it) for _ in range(1 + r)]
                hit.wait(30)
                if r == 0:
                    c.reshard(new_world)
                go.wait(30)
                got.extend(it)
                delivered[r] = np.concatenate(got)

        def joiner():
            deadline = time.monotonic() + 30.0
            while srv.generation < 1:  # dial after the commit
                assert time.monotonic() < deadline, "the barrier never "\
                    "committed"
                time.sleep(0.01)
            with S.ServiceIndexClient(srv.address, rank=None, **kw) as c:
                parts = list(c.epoch_batches(1))
                delivered[c.rank] = np.concatenate(parts)

        def run(fn):
            try:
                fn()
            except BaseException as exc:  # reported below
                errors.append(exc)
                hit.abort()
                go.abort()

        threads = ([threading.Thread(target=run, args=(lambda r=r:
                                                       old_rank(r),))
                    for r in range(old_world)]
                   + [threading.Thread(target=run, args=(joiner,))
                      for _ in range(max(0, new_world - old_world))])
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive(), "an elastic client hung"
        layers = srv._state_dict()["layers"]
    assert not errors, errors
    return [list(map(int, layer)) for layer in layers], delivered


@pytest.mark.parametrize("kind", ["plain", "mixture", "shard"])
@pytest.mark.parametrize("old_world,new_world", [(2, 3), (3, 2)])
def test_reshard_delivers_the_same_bytes_in_both_packages(kind, old_world,
                                                          new_world):
    """The same scripted mid-epoch reshard against a JAX daemon and a
    port daemon: the same barrier, and every rank's delivered stream (its
    old partition to the barrier, then its share of the remainder) is
    byte-equal, joiners' included."""
    (j_layers, j_got), (p_layers, p_got) = (
        _scripted_reshard(S, spec, new_world)
        for S, spec in zip((JS, PS), spec_pair(kind, old_world)))
    assert j_layers == p_layers and len(j_layers) == 1
    assert j_layers[0][0] == old_world
    assert sorted(j_got) == sorted(p_got) == list(
        range(max(old_world, new_world)))
    for r in j_got:
        assert j_got[r].dtype == p_got[r].dtype, r
        assert np.array_equal(j_got[r], p_got[r]), r


def test_multi_tenant_server_of_one_package_hosts_the_others_jobs():
    """A port daemon (multi-tenant) hosts a JAX plain job and a JAX
    mixture job: each HELLO creates its namespace from the JAX client's
    wire spec, and the streams are the JAX specs'."""
    (jp, pp), (jm, _) = spec_pair("plain"), spec_pair("mixture")
    with PS.IndexServer(pp, multi_tenant=True) as srv:
        plain = _stream(JS, srv.address, 1, spec=jp)
        mixture = _stream(JS, srv.address, 0, spec=jm)
        assert len(srv.tenants()) == 2
    assert np.array_equal(plain, np.asarray(jp.rank_indices(1, 1)))
    assert np.array_equal(mixture, np.asarray(jm.rank_indices(1, 0)))
