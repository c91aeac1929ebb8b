"""The port's counterpart of the JAX package's ``tests/test_durability.py``.

Every case runs on ``partiallyshuffledistributedsampler_tpu_torch`` with its
specs and loaders on ``backend="cpu"`` (no card), under the port's
lock-order sanitizer; the JAX file's text follows.

Durability: the disk-backed WAL, incremental checkpoints, and
crash-consistent recovery (docs/RESILIENCE.md "Durability & recovery").

The laws under test:

* a torn tail — a crash mid-frame, at ANY byte — is detected on open,
  cut, and never silently replayed; recovery from the cut succeeds and
  rebuilds exactly the state the surviving prefix describes;
* fsync policy changes durability timing, never content: the segment
  bytes are identical under ``per_record``/``group_commit``/``off``;
* checkpoint GC never deletes a record above the watermark floor, and a
  never-sealed owner (tenant) pins the whole log;
* recovery replays the tail above each owner's checkpoint — bounded by
  tail length, with point-in-time stops — and a corrupt newest snapshot
  falls back to the retained previous checkpoint instead of refusing.
"""

from __future__ import annotations

import json
import os
import shutil
import time
import warnings

import numpy as np
import pytest

from partiallyshuffledistributedsampler_tpu_torch import faults as F
from partiallyshuffledistributedsampler_tpu_torch.durability import (
    FsyncPolicy,
    RecoveryError,
    WriteAheadLog,
    check_invariants,
    last_valid_lsn,
    replay_wal_tail,
    truncate_wal_copy,
    wal_total_bytes,
)
from partiallyshuffledistributedsampler_tpu_torch.durability.wal import (
    _FRAME,
    _encode,
)
from partiallyshuffledistributedsampler_tpu_torch.durability.recover import (
    recover_unstarted,
)
from partiallyshuffledistributedsampler_tpu_torch.ops.mixture import MixtureSpec
from partiallyshuffledistributedsampler_tpu_torch.service import (
    IndexServer,
    PartialShuffleSpec,
    ServiceIndexClient,
)
from partiallyshuffledistributedsampler_tpu_torch.service.replication import (
    ReplicationLog,
)
from partiallyshuffledistributedsampler_tpu_torch.telemetry.export import JsonlSink
from partiallyshuffledistributedsampler_tpu_torch.telemetry.recorder import (
    FlightRecorder,
)
from partiallyshuffledistributedsampler_tpu_torch.utils.checkpoint import (
    durable_write_text,
    save_sampler_state,
)

from partiallyshuffledistributedsampler_tpu_torch.analysis import lockorder
from partiallyshuffledistributedsampler_tpu import (
    durability as JD,
)
from partiallyshuffledistributedsampler_tpu import (
    service as JS,
)
from partiallyshuffledistributedsampler_tpu.durability import (
    recover as JR,
    wal as JW,
)
from partiallyshuffledistributedsampler_tpu.ops.mixture import (
    MixtureSpec as JMixtureSpec,
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

pytestmark = pytest.mark.durability


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


def _cursor_rec(lsn, rank, x, epoch=0):
    return {"lsn": lsn, "op": "cursor", "rank": rank, "epoch": epoch,
            "acked": x, "hi": x, "samples": x}


def _fold(records):
    """Reference fold of a WAL prefix into ``(epoch, cursors)`` per
    owner (``None`` is the front server) — what a correct recovery must
    reconstruct bit-exactly."""
    out: dict = {}
    for rec in records:
        owner = out.setdefault(rec.get("tenant"), {"epoch": 0,
                                                   "cursors": {}})
        op = rec.get("op")
        if op == "epoch":
            owner["epoch"] = int(rec["epoch"])
        elif op == "cursor":
            owner["cursors"][int(rec["rank"])] = {
                "epoch": int(rec["epoch"]), "acked": int(rec["acked"]),
                "hi": int(rec["hi"]), "samples": int(rec["samples"])}
    return out


def _read_all(wal_dir):
    w = WriteAheadLog(wal_dir, fsync="off")
    try:
        return w.read_records()
    finally:
        w.close(sync=False)


# ---------------------------------------------------------------- FsyncPolicy
def test_fsync_policy_parse_and_validation():
    assert FsyncPolicy.parse("per_record").mode == "per_record"
    assert FsyncPolicy.parse("off").mode == "off"
    p = FsyncPolicy.parse("group_commit(2.5, 16)")
    assert p == FsyncPolicy("group_commit", max_ms=2.5, max_records=16)
    assert FsyncPolicy.parse(p) is p
    assert repr(p) == "group_commit(2.5, 16)"
    with pytest.raises(ValueError):
        FsyncPolicy.parse("fsync_sometimes")
    with pytest.raises(ValueError):
        FsyncPolicy("group_commit", max_records=0)
    # a bad policy fails server construction, not the first append
    with pytest.raises(ValueError):
        IndexServer(plain_spec(), fsync="nope")


# ------------------------------------------------------------- WAL mechanics
def test_wal_roundtrip_rotation_and_reopen(tmp_path):
    d = str(tmp_path / "wal")
    w = WriteAheadLog(d, fsync="per_record", segment_bytes=256)
    for i in range(1, 60):
        assert w.append(_cursor_rec(i, 0, i))
    assert len(w.segment_paths()) > 3, "rotation never happened"
    w.close()
    w2 = WriteAheadLog(d)
    assert w2.last_lsn == 59
    recs = w2.read_records()
    assert [r["lsn"] for r in recs] == list(range(1, 60))
    check_invariants(recs)
    # point reads: after/upto honor exact lsn bounds across segments
    assert [r["lsn"] for r in w2.read_records(after_lsn=17, upto_lsn=23)] \
        == [18, 19, 20, 21, 22, 23]
    w2.close()


def test_torn_tail_goldens(tmp_path):
    """Hand-built corruption: a half header, a cut payload, a flipped
    byte mid-file, and a fully-garbage last segment — each is detected,
    logged, and cut on open; nothing after the tear survives."""
    def build(d, upto=20):
        w = WriteAheadLog(str(d), fsync="per_record", segment_bytes=220)
        for i in range(1, upto + 1):
            w.append(_cursor_rec(i, 0, i))
        w.close()
        return sorted(str(d / n) for n in os.listdir(d))

    # (a) half a frame header appended to the last segment
    segs = build(tmp_path / "a")
    with open(segs[-1], "ab") as f:
        f.write(b"\x07\x00")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        w = WriteAheadLog(str(tmp_path / "a"))
    assert w.last_lsn == 20 and w.torn_bytes == 2
    assert any("torn tail" in str(c.message) for c in caught)
    w.close()

    # (b) a full header but a cut payload
    segs = build(tmp_path / "b")
    frame = _encode({"lsn": 21, "op": "noop"})
    with open(segs[-1], "ab") as f:
        f.write(frame[:-3])
    w = WriteAheadLog(str(tmp_path / "b"))
    assert w.last_lsn == 20 and w.torn_bytes == len(frame) - 3
    # the cut is clean: appending after recovery keeps the chain valid
    w.append({"lsn": 21, "op": "noop"})
    assert [r["lsn"] for r in w.read_records()] == list(range(1, 22))
    w.close()

    # (c) a flipped byte in an EARLY segment drops everything after it
    segs = build(tmp_path / "c")
    with open(segs[0], "r+b") as f:
        f.seek(_FRAME.size + 3)
        byte = f.read(1)
        f.seek(_FRAME.size + 3)
        f.write(bytes([byte[0] ^ 0xFF]))
    w = WriteAheadLog(str(tmp_path / "c"))
    assert w.last_lsn == 0, "records past a mid-file tear must not replay"
    assert not any(os.path.getsize(p) for p in segs[1:] if os.path.exists(p))
    w.close()

    # (d) a fully-garbage last segment is dropped as an empty shell
    segs = build(tmp_path / "d")
    with open(segs[-1], "wb") as f:
        f.write(b"\xde\xad\xbe\xef" * 8)
    w = WriteAheadLog(str(tmp_path / "d"))
    assert not os.path.exists(segs[-1])
    assert w.last_lsn == int(
        _read_all(str(tmp_path / "d"))[-1]["lsn"]) == w.read_records()[-1]["lsn"]
    w.close()


def test_fsync_policy_changes_timing_never_bytes(tmp_path):
    """group_commit vs per_record vs off: identical segment files —
    the policy decides when the page cache is forced out, not what is
    written."""
    recs = [_cursor_rec(i, i % 4, i * 3) for i in range(1, 80)]
    blobs = {}
    for policy in ("per_record", "group_commit(5, 8)", "off"):
        d = tmp_path / policy.replace("(", "_").replace(")", "").replace(
            ",", "").replace(" ", "")
        w = WriteAheadLog(str(d), fsync=policy, segment_bytes=512)
        for r in recs:
            w.append(r)
        w.close()
        blobs[policy] = [(os.path.basename(p), open(p, "rb").read())
                         for p in sorted(
                             str(d / n) for n in os.listdir(d))]
    assert blobs["per_record"] == blobs["group_commit(5, 8)"] == blobs["off"]


def test_gc_never_deletes_above_watermark(tmp_path):
    d = str(tmp_path / "wal")
    w = WriteAheadLog(d, fsync="off", segment_bytes=200)
    for i in range(1, 61):
        w.append(_cursor_rec(i, 0, i))
    w.register_owner("front")
    assert w.checkpoint("front", 30) == 0, "one checkpoint must not GC"
    n = w.checkpoint("front", 50)
    assert n > 0, "two checkpoints past whole segments must GC"
    assert w.watermark_floor() == 30
    # every record above the floor is still readable, densely
    recs = w.read_records(after_lsn=30)
    assert [r["lsn"] for r in recs] == list(range(31, 61))
    # a never-sealed owner pins the log: no further GC while it exists
    w.register_owner("tenant-b")
    before = len(w.segment_paths())
    w.checkpoint("front", 55)
    w.checkpoint("front", 60)
    assert len(w.segment_paths()) == before
    assert w.watermark_floor() == 0
    # once the tenant seals twice, GC resumes at the joint floor
    w.checkpoint("tenant-b", 58)
    w.checkpoint("tenant-b", 60)
    assert w.watermark_floor() == min(55, 58)
    recs = w.read_records(after_lsn=55)
    assert [r["lsn"] for r in recs] == list(range(56, 61))
    w.close()


def test_append_fault_holes_are_noop_filled(tmp_path):
    """A dropped append (injected disk_full) leaves no hole: the next
    successful append writes noop fillers, the on-disk sequence stays
    dense, and recovery's invariant check passes."""
    d = str(tmp_path / "wal")
    w = WriteAheadLog(d, fsync="off")
    plan = F.FaultPlan([F.FaultRule(site="wal.append", kind="disk_full",
                                    nth=2, count=2)])
    with plan:
        dropped = 0
        for i in range(1, 8):
            if not w.append(_cursor_rec(i, 0, i)):
                dropped += 1
    assert plan.fired("wal.append") == 2 and dropped == 2
    w.close()
    recs = _read_all(d)
    assert [r["lsn"] for r in recs] == list(range(1, 8))
    assert [r["op"] for r in recs].count("noop") == 2
    check_invariants(recs)


def test_check_invariants_rejects_bad_tails():
    ok = [_cursor_rec(1, 0, 5), _cursor_rec(2, 0, 9)]
    check_invariants(ok)
    with pytest.raises(RecoveryError, match="non-dense"):
        check_invariants([_cursor_rec(1, 0, 5), _cursor_rec(3, 0, 9)])
    with pytest.raises(RecoveryError, match="regression"):
        check_invariants([_cursor_rec(1, 0, 9), _cursor_rec(2, 0, 5)])
    # an epoch change legally resets the watermarks
    check_invariants([_cursor_rec(1, 0, 9), _cursor_rec(2, 0, 0, epoch=1)])
    # two tenants' rank-0 cursors are independent sequences
    check_invariants([_cursor_rec(1, 0, 9),
                      {**_cursor_rec(2, 0, 3), "tenant": "tb"}])
    with pytest.raises(RecoveryError, match="missing"):
        check_invariants([{"lsn": 1, "op": "state",
                           "state": {"reshard": {"target_world": 2}}}])
    with pytest.raises(RecoveryError, match="not barrier participants"):
        check_invariants([{"lsn": 1, "op": "state", "state": {"reshard": {
            "target_world": 2, "epoch": 0, "barrier_units": 4,
            "targets": {"0": 10}, "drained": [0, 3]}}}])


# --------------------------------------------------------- repl-log over WAL
def test_replication_log_take_falls_back_to_segments(tmp_path):
    """A deque that rotated past a slow standby's cursor reads the
    catch-up tail from the segments instead of forcing a full re-SYNC;
    only a tail the checkpoint GC already cut still resyncs."""
    w = WriteAheadLog(str(tmp_path / "wal"), fsync="off", segment_bytes=256)
    log = ReplicationLog(tail=4, wal=w)
    for i in range(12):
        log.append("epoch", {"epoch": i})
    recs, resync = log.take(0, timeout=0.01)
    assert not resync
    assert [r["lsn"] for r in recs] == list(range(1, 13))
    # without a WAL the same rotation forces the re-SYNC
    bare = ReplicationLog(tail=4)
    for i in range(12):
        bare.append("epoch", {"epoch": i})
    assert bare.take(0, timeout=0.01) == ([], True)
    # GC past the cursor: the disk tail no longer reaches back either
    w.register_owner("front")
    w.checkpoint("front", 8)
    w.checkpoint("front", 12)
    assert w.watermark_floor() == 8
    if len(w.segment_paths()) > 1:
        _, resync = log.take(0, timeout=0.01)
        assert resync
    w.close()


def test_replication_log_lsn_resumes_from_wal(tmp_path):
    d = str(tmp_path / "wal")
    w = WriteAheadLog(d, fsync="off")
    log = ReplicationLog(wal=w)
    for i in range(5):
        log.append("epoch", {"epoch": i})
    w.close()
    w2 = WriteAheadLog(d)
    log2 = ReplicationLog(wal=w2)
    assert log2.lsn == 5
    log2.append("epoch", {"epoch": 9})
    recs = w2.read_records()
    assert [r["lsn"] for r in recs] == [1, 2, 3, 4, 5, 6]
    w2.close()


# -------------------------------------------------------- recovery / matrix
def _serve_partial(spec, wal_dir, *, epoch=3, batches=3, batch=17,
                   snapshot_path=None, **kw):
    """Start a WAL-backed server, set ``epoch``, serve ``batches``
    batches to every rank, and kill it — the recorded pre-crash run."""
    srv = IndexServer(spec, port=0, wal_dir=wal_dir,
                      snapshot_path=snapshot_path, **kw)
    host, port = srv.start()
    with ServiceIndexClient((host, port), rank=0, batch=batch) as c:
        c.set_epoch(epoch)
    for r in range(spec.world):
        c = ServiceIndexClient((host, port), rank=r, batch=batch)
        it = c.epoch_batches(epoch)
        for _ in range(batches):
            next(it)
        c.close()
    srv.kill()
    return srv


@pytest.mark.parametrize("mode", sorted(SPECS))
def test_kill_at_any_byte_crash_matrix(mode, tmp_path):
    """Truncate the recorded WAL at EVERY byte offset, recover, and
    assert the rebuilt state is bit-exactly the fold of the surviving
    record prefix; at sampled offsets, restart the full daemon and
    assert the resumed client streams are bit-identical to the
    uncrashed run."""
    spec = SPECS[mode](world=2)
    wal_dir = str(tmp_path / "wal")
    _serve_partial(spec, wal_dir)
    full = _read_all(wal_dir)
    assert full, "the pre-crash run recorded nothing"
    folds = {0: _fold([])}
    for i in range(len(full)):
        folds[int(full[i]["lsn"])] = _fold(full[:i + 1])
    total = wal_total_bytes(wal_dir)
    cut_dir = str(tmp_path / "cut")
    resume_at = sorted({0, 1, total // 3, total - 1, total})
    refs = {r: np.asarray(spec.rank_indices(3, r)) for r in range(2)}
    for cut in range(total + 1):
        shutil.rmtree(cut_dir, ignore_errors=True)
        truncate_wal_copy(wal_dir, cut_dir, cut)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # torn-tail warns at most cuts
            fresh = IndexServer(SPECS[mode](world=2), wal_dir=cut_dir)
            stats = recover_unstarted(fresh)
        lsn = last_valid_lsn(cut_dir)
        expect = folds[lsn][None] if lsn else {"epoch": 0, "cursors": {}}
        assert fresh.epoch == expect["epoch"], f"cut={cut}"
        assert fresh._cursors == expect["cursors"], f"cut={cut}"
        assert stats["last_lsn"] in (0, lsn), f"cut={cut}"
        if cut in resume_at:
            host, port = fresh.start()
            try:
                for r in range(2):
                    with ServiceIndexClient((host, port), rank=r,
                                            batch=41) as c:
                        got = np.concatenate(list(c.epoch_batches(3)))
                    assert np.array_equal(got, refs[r]), \
                        f"stream diverged after recovery at cut={cut}"
            finally:
                fresh.stop()
        else:
            fresh._wal.close(sync=False)


def test_crash_matrix_multi_tenant_watermark_isolation(tmp_path):
    """Two tenants share one WAL: the crash matrix (strided) recovers
    BOTH tenants' cursors bit-exactly at every cut, and one tenant's
    checkpoints never let GC cut records the other still needs."""
    front, other = plain_spec(world=1), shard_spec(world=1)
    wal_dir = str(tmp_path / "wal")
    srv = IndexServer(front, port=0, wal_dir=wal_dir, multi_tenant=True)
    host, port = srv.start()
    for spec in (front, other):
        c = ServiceIndexClient((host, port), rank=0, batch=33, spec=spec)
        it = c.epoch_batches(0)
        for _ in range(3):
            next(it)
        c.close()
    tid = srv._engines()[0].tenant_id
    srv.kill()
    full = _read_all(wal_dir)
    assert any(r.get("tenant") == tid for r in full), "tenant never tagged"
    total = wal_total_bytes(wal_dir)
    cut_dir = str(tmp_path / "cut")
    for cut in range(0, total + 1, 7):
        shutil.rmtree(cut_dir, ignore_errors=True)
        truncate_wal_copy(wal_dir, cut_dir, cut)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            fresh = IndexServer(plain_spec(world=1), wal_dir=cut_dir,
                                multi_tenant=True)
            recover_unstarted(fresh)
        lsn = last_valid_lsn(cut_dir)
        fold = _fold([r for r in full if int(r["lsn"]) <= lsn])
        assert fresh._cursors == fold.get(None, {"cursors": {}})["cursors"]
        eng = fresh._tenant_by_id.get(tid)
        want = fold.get(tid, {"cursors": {}})["cursors"]
        got = eng._cursors if eng is not None else {}
        assert got == want, f"tenant cursors diverged at cut={cut}"
        fresh._wal.close(sync=False)
    # watermark isolation at the WAL layer: the front sealing twice
    # must not GC the tenant's records while the tenant never sealed
    w = WriteAheadLog(wal_dir, fsync="off")
    w.register_owner("front")
    w.register_owner(tid)
    w.checkpoint("front", w.last_lsn)
    w.checkpoint("front", w.last_lsn)
    assert w.watermark_floor() == 0
    assert [r["lsn"] for r in w.read_records()] == \
        [r["lsn"] for r in full], "GC cut a never-sealed tenant's records"
    w.close()


def test_point_in_time_recovery_to_arbitrary_lsn(tmp_path):
    spec = plain_spec(world=2)
    wal_dir = str(tmp_path / "wal")
    _serve_partial(spec, wal_dir)
    full = _read_all(wal_dir)
    for upto in (1, len(full) // 2, len(full)):
        target = int(full[upto - 1]["lsn"])
        fresh = IndexServer(plain_spec(world=2))
        fresh._wal = WriteAheadLog(wal_dir, fsync="off")
        stats = replay_wal_tail(fresh, upto_lsn=target)
        fresh._wal.close(sync=False)
        expect = _fold(full[:upto])[None]
        assert stats["last_lsn"] == target
        assert fresh.epoch == expect["epoch"]
        assert fresh._cursors == expect["cursors"]


def test_recovery_replays_only_above_checkpoint(tmp_path):
    """With snapshot seals as incremental checkpoints, a restart loads
    the checkpoint and replays ONLY the tail above its watermark —
    recovery cost tracks the tail, not history."""
    spec = plain_spec(world=1)
    snap = str(tmp_path / "s.json")
    wal_dir = str(tmp_path / "wal")
    srv = IndexServer(spec, port=0, snapshot_path=snap, wal_dir=wal_dir,
                      snapshot_interval=4)
    host, port = srv.start()
    with ServiceIndexClient((host, port), rank=0, batch=33) as c:
        ref = np.concatenate(list(c.epoch_batches(0)))
    srv.kill()
    ckpt = json.load(open(snap)).get("wal_lsn", 0)
    assert ckpt > 0, "no seal recorded a watermark"
    fresh = IndexServer(plain_spec(world=1), snapshot_path=snap,
                        wal_dir=wal_dir)
    stats = recover_unstarted(fresh)
    tail = [r for r in _read_all(wal_dir) if int(r["lsn"]) > ckpt]
    assert stats["replayed"] <= len(tail) + 1
    assert fresh._ckpt_lsn == ckpt
    host, port = fresh.start()
    try:
        with ServiceIndexClient((host, port), rank=0, batch=33) as c:
            assert np.array_equal(
                np.concatenate(list(c.epoch_batches(0))), ref)
    finally:
        fresh.stop()
    counters = fresh.metrics.report()["counters"]
    assert counters.get("wal_recoveries", 0) >= 1


@pytest.mark.parametrize("mode", sorted(SPECS))
def test_same_client_rides_through_crash_and_recovery(mode, tmp_path):
    """A client mid-epoch when the daemon is killed resumes against the
    recovered daemon on the same address and its delivered stream is
    bit-identical — the WAL carries the epoch and cursors no snapshot
    ever persisted (kill() writes none)."""
    spec = SPECS[mode](world=1)
    wal_dir = str(tmp_path / "wal")
    ref = np.asarray(spec.rank_indices(5, 0))
    srv = IndexServer(spec, port=0, wal_dir=wal_dir)
    host, port = srv.start()
    client = ServiceIndexClient((host, port), rank=0, batch=37,
                                backoff_base=0.01, reconnect_timeout=10.0)
    try:
        client.set_epoch(5)
        it = client.epoch_batches(5)
        got = [next(it) for _ in range(3)]
        srv.kill()
        srv2 = IndexServer(SPECS[mode](world=1), host=host, port=port,
                           wal_dir=wal_dir)
        srv2.start()
        try:
            assert srv2.epoch == 5, "the set_epoch lived only in the WAL"
            got.extend(it)
        finally:
            srv2.stop()
    finally:
        client.close()
    assert np.array_equal(np.concatenate(got), ref), \
        f"stream diverged across crash+recover ({mode})"


@pytest.mark.parametrize("mode", sorted(SPECS))
def test_double_failure_recovery_bit_identical(mode, tmp_path):
    """Primary AND standby die; a fresh primary restored from the WAL
    alone serves streams bit-identical to the uncrashed run."""
    spec = SPECS[mode](world=1)
    wal_dir = str(tmp_path / "wal")
    ref = np.asarray(spec.rank_indices(2, 0))
    standby = IndexServer(SPECS[mode](world=1), role="standby",
                          repl_feed_timeout=60.0)
    standby.start()
    primary = IndexServer(spec, port=0, standby=standby.address,
                          wal_dir=wal_dir)
    host, port = primary.start()
    client = ServiceIndexClient((host, port), rank=0, batch=41,
                                backoff_base=0.01, reconnect_timeout=10.0)
    try:
        client.set_epoch(2)
        it = client.epoch_batches(2)
        got = [next(it) for _ in range(2)]
        primary.kill()   # both peers die: failover is NOT available
        standby.kill()
        revived = IndexServer(SPECS[mode](world=1), host=host, port=port,
                              wal_dir=wal_dir)
        revived.start()
        try:
            assert revived.epoch == 2
            got.extend(it)
        finally:
            revived.stop()
    finally:
        client.close()
    assert np.array_equal(np.concatenate(got), ref), \
        f"double-failure recovery diverged ({mode})"


# --------------------------------------------------- snapshot fallback path
def test_corrupt_snapshot_falls_back_to_previous_checkpoint(tmp_path):
    spec = plain_spec(world=1)
    snap = str(tmp_path / "s.json")
    wal_dir = str(tmp_path / "wal")
    srv = IndexServer(spec, port=0, snapshot_path=snap, wal_dir=wal_dir,
                      snapshot_interval=2)
    host, port = srv.start()
    with ServiceIndexClient((host, port), rank=0, batch=33) as c:
        c.epoch_indices(0)
    final_cursors = dict(srv._cursors)
    srv.stop()
    assert os.path.exists(snap + ".prev"), "no previous checkpoint kept"
    state = json.load(open(snap))
    state["generation"] = int(state.get("generation", 0)) + 1  # stale crc32
    json.dump(state, open(snap, "w"))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fresh = IndexServer(plain_spec(world=1), snapshot_path=snap,
                            wal_dir=wal_dir)
        recover_unstarted(fresh)
    assert fresh.metrics.report()["counters"].get("snapshot_fallbacks") == 1
    assert any("fell back" in str(c.message) for c in caught)
    assert fresh._cursors == final_cursors, \
        "previous checkpoint + tail replay lost state"
    fresh._wal.close(sync=False)
    # without a WAL the same corruption still refuses loudly (no silent
    # half-load): pre-durability behavior is unchanged
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        bare = IndexServer(plain_spec(world=1), snapshot_path=snap)
        bare._recover_from_disk()
    assert bare._cursors == {}
    assert bare.metrics.report()["counters"].get("snapshot_corrupt") == 1


def test_corrupt_tenant_snapshot_falls_back(tmp_path):
    front, other = plain_spec(world=1), shard_spec(world=1)
    snap = str(tmp_path / "s.json")
    wal_dir = str(tmp_path / "wal")
    srv = IndexServer(front, port=0, snapshot_path=snap, wal_dir=wal_dir,
                      multi_tenant=True, snapshot_interval=2)
    host, port = srv.start()
    with ServiceIndexClient((host, port), rank=0, batch=33,
                            spec=other) as c:
        c.epoch_indices(0)
    eng = srv._engines()[0]
    tid, tsnap = eng.tenant_id, eng.snapshot_path
    tenant_cursors = dict(eng._cursors)
    srv.stop()
    assert os.path.exists(tsnap + ".prev")
    with open(tsnap, "r+b") as f:   # torn tenant snapshot: truncate it
        f.truncate(os.path.getsize(tsnap) // 2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fresh = IndexServer(plain_spec(world=1), snapshot_path=snap,
                            wal_dir=wal_dir, multi_tenant=True)
        recover_unstarted(fresh)
    eng2 = fresh._tenant_by_id.get(tid)
    assert eng2 is not None, "tenant lost to a corrupt snapshot"
    assert eng2._cursors == tenant_cursors
    fresh._wal.close(sync=False)


# ------------------------------------------------------ durable dump helpers
def test_flight_dump_and_sink_share_the_durable_write_path(tmp_path,
                                                           monkeypatch):
    """FlightRecorder dumps and explicit JsonlSink flushes go through
    the same fsync primitives as ``save_sampler_state(durable=True)`` —
    a post-mortem written just before the host dies must survive it."""
    calls = []
    real = os.fsync
    monkeypatch.setattr(os, "fsync",
                        lambda fd: (calls.append(fd), real(fd))[1])
    save_sampler_state(str(tmp_path / "s.json"), {"x": 1}, durable=True)
    assert len(calls) == 2, "file + directory fsync"
    calls.clear()
    rec = FlightRecorder(capacity=8)
    rec.record({"kind": "event", "name": "boom"})
    out = rec.dump(str(tmp_path / "dump.jsonl"), reason="test")
    assert len(calls) == 2, "flight dump must be write+fsync, not a write"
    lines = open(out).read().splitlines()
    assert json.loads(lines[0])["kind"] == "flight_dump"
    assert len(lines) == 2
    calls.clear()
    with JsonlSink(str(tmp_path / "t.jsonl"), durable=True) as sink:
        sink.write({"a": 1})
        sink.flush()
        assert len(calls) == 1, "explicit flush fsyncs when durable"
    assert len(calls) == 2, "close fsyncs the tail when durable"
    calls.clear()
    with JsonlSink(str(tmp_path / "u.jsonl")) as sink:
        sink.write({"a": 1})
        sink.flush()
    assert calls == [], "non-durable sink stays a page-cache write"
    calls.clear()
    durable_write_text(str(tmp_path / "v.txt"), "hello", durable=False)
    assert calls == [] and open(tmp_path / "v.txt").read() == "hello"


# ------------------------------------------------ shipped-tail crash matrix
def test_shipped_wal_tail_kill_at_any_byte(tmp_path):
    """The cross-cell variant of the kill-at-any-byte matrix
    (docs/FEDERATION.md): the home cell's WAL is SHIPPED to a remote
    standby that write-throughs every applied record into its own
    segment WAL.  Truncate the RECEIVING cell's copy at every byte
    offset: recovery is folded-prefix-exact against the shipped
    records, never wedged — and at sampled offsets a daemon restarted
    over the cut copy serves bit-identical resumed streams.  This is
    the artifact the DR law recovers from when home + standby + router
    die together."""
    from partiallyshuffledistributedsampler_tpu_torch.federation import WalShipper

    spec = plain_spec(world=2)
    east = str(tmp_path / "east")
    west = str(tmp_path / "west")
    primary = IndexServer(spec, wal_dir=east)
    remote = IndexServer(plain_spec(world=2), role="standby",
                         repl_feed_timeout=60.0, wal_dir=west)
    remote.start()
    primary.start()
    shipper = WalShipper(primary._repl_log, remote.address,
                         cell_id="east", target_cell="west",
                         state_fn=primary._repl_sync_state,
                         term_fn=lambda: primary.term,
                         on_fenced=lambda term: None,
                         metrics=primary.metrics)
    shipper.start()
    # sync BEFORE traffic: the receiving WAL then holds the dense
    # record stream from lsn 1 (nothing is folded into the bootstrap)
    assert shipper.synced.wait(10.0)
    with ServiceIndexClient(primary.address, rank=0, batch=17) as c:
        c.set_epoch(3)
    for r in range(2):
        c = ServiceIndexClient(primary.address, rank=r, batch=17)
        it = c.epoch_batches(3)
        for _ in range(3):
            next(it)
        c.close()
    deadline = time.monotonic() + 10.0
    while shipper.shipped_lsn < primary._repl_log.lsn:
        assert time.monotonic() < deadline, "shipped tail never drained"
        time.sleep(0.01)
    shipper.stop()
    primary.kill()
    remote.kill()
    full = _read_all(west)
    assert full, "nothing was shipped into the receiving WAL"
    lsns = [int(r["lsn"]) for r in full]
    assert lsns == list(range(1, len(full) + 1)), (
        "the shipped copy is not a dense 1-based sequence")
    folds = {0: _fold([])}
    for i in range(len(full)):
        folds[int(full[i]["lsn"])] = _fold(full[:i + 1])
    total = wal_total_bytes(west)
    cut_dir = str(tmp_path / "cut")
    resume_at = sorted({0, 1, total // 3, total - 1, total})
    refs = {r: np.asarray(spec.rank_indices(3, r)) for r in range(2)}
    for cut in range(total + 1):
        shutil.rmtree(cut_dir, ignore_errors=True)
        truncate_wal_copy(west, cut_dir, cut)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # torn-tail warns at most cuts
            fresh = IndexServer(plain_spec(world=2), wal_dir=cut_dir)
            stats = recover_unstarted(fresh)
        lsn = last_valid_lsn(cut_dir)
        expect = folds[lsn][None] if lsn else {"epoch": 0, "cursors": {}}
        assert fresh.epoch == expect["epoch"], f"cut={cut}"
        assert fresh._cursors == expect["cursors"], f"cut={cut}"
        assert stats["last_lsn"] in (0, lsn), f"cut={cut}"
        if cut in resume_at:
            host, port = fresh.start()
            try:
                for r in range(2):
                    with ServiceIndexClient((host, port), rank=r,
                                            batch=41) as c:
                        got = np.concatenate(list(c.epoch_batches(3)))
                    assert np.array_equal(got, refs[r]), (
                        f"shipped-tail recovery diverged at cut={cut}")
            finally:
                fresh.stop()
        else:
            fresh._wal.close(sync=False)



# ------------------------------------------------- across the two packages

#: the same three streams as JAX specs (the JAX package's file builds them)
JAX_SPECS = {
    "plain": lambda world=1: JS.PartialShuffleSpec.plain(
        530, window=32, seed=7, world=world),
    "mixture": lambda world=1: JS.PartialShuffleSpec.mixture(
        JMixtureSpec([100, 200, 50], [5, 3, 2], block=16), seed=3,
        world=world, epoch_samples=300),
    "shard": lambda world=1: JS.PartialShuffleSpec.shard(
        [17, 5, 29, 11, 40, 8, 23, 9], window=4, seed=9, world=world,
        within_shard_shuffle=True),
}
#: package name -> (IndexServer, ServiceIndexClient, spec makers,
#: recover_unstarted)
PACKAGES = {
    "jax": (JS.IndexServer, JS.ServiceIndexClient, JAX_SPECS,
            JR.recover_unstarted),
    "port": (IndexServer, ServiceIndexClient, SPECS, recover_unstarted),
}


def test_the_same_records_give_byte_equal_segments(tmp_path):
    """Records of every shape, rotated across small segments: each
    package writes the same files, byte for byte, and reads the other's."""
    rng = np.random.default_rng(12)
    records = [_cursor_rec(i, int(rng.integers(0, 4)),
                           int(rng.integers(0, 1 << 40)))
               for i in range(1, 30)]
    records += [{"lsn": 30, "op": "epoch", "epoch": 9, "note": "é ✓"},
                {"lsn": 31, "op": "state", "state": {"layers": [[8, 5]],
                                                     "x": None}}]
    for rec in records:
        assert _encode(rec) == JW._encode(rec)
    dirs = {}
    for name, W in (("jax", JD.WriteAheadLog), ("port", WriteAheadLog)):
        d = tmp_path / name
        w = W(str(d), fsync="per_record", segment_bytes=300)
        for rec in records:
            w.append(rec)
        w.close()
        dirs[name] = {p.name: p.read_bytes() for p in sorted(d.iterdir())}
    assert len(dirs["port"]) > 3 and dirs["jax"] == dirs["port"]
    for W, other in ((JD.WriteAheadLog, "port"), (WriteAheadLog, "jax")):
        w = W(str(tmp_path / other), fsync="off")
        assert w.read_records() == records
        w.close(sync=False)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize("mode", sorted(SPECS))
def test_recovery_reads_the_other_packages_wal(writer, reader, mode,
                                               tmp_path):
    """One package's daemon records a partial epoch and is killed; the
    WAL cut at sampled byte offsets (torn tails included) recovers in the
    other package's daemon to the state that package recovers from its
    own copy, and the resumed streams are the spec's."""
    W_srv, W_cli, w_specs, _ = PACKAGES[writer]
    R_srv, R_cli, r_specs, r_recover = PACKAGES[reader]
    wal_dir = str(tmp_path / "wal")
    srv = W_srv(w_specs[mode](world=2), port=0, wal_dir=wal_dir)
    host, port = srv.start()
    with W_cli((host, port), rank=0, batch=17) as c:
        c.set_epoch(3)
    for r in range(2):
        c = W_cli((host, port), rank=r, batch=17)
        it = c.epoch_batches(3)
        for _ in range(3):
            next(it)
        c.close()
    srv.kill()
    full = _read_all(wal_dir)
    total = wal_total_bytes(wal_dir)
    refs = {r: np.asarray(w_specs[mode](world=2).rank_indices(3, r))
            for r in range(2)}
    for cut in sorted({0, 1, 9, total // 3, total // 2, total - 1, total}):
        cut_dir = str(tmp_path / f"cut{cut}")
        truncate_wal_copy(wal_dir, cut_dir, cut)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # torn-tail warns at most cuts
            fresh = R_srv(r_specs[mode](world=2), wal_dir=cut_dir)
            r_recover(fresh)
        lsn = last_valid_lsn(cut_dir)
        expect = (_fold([r for r in full if int(r["lsn"]) <= lsn])[None]
                  if lsn else {"epoch": 0, "cursors": {}})
        assert fresh.epoch == expect["epoch"], f"cut={cut}"
        assert fresh._cursors == expect["cursors"], f"cut={cut}"
        if cut in (total // 3, total):
            host, port = fresh.start()
            try:
                for r in range(2):
                    with R_cli((host, port), rank=r, batch=41) as c:
                        got = np.concatenate(list(c.epoch_batches(3)))
                    assert np.array_equal(got, refs[r]), f"cut={cut}"
            finally:
                fresh.stop()
        else:
            fresh._wal.close(sync=False)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_a_snapshot_restores_in_the_other_package(writer, reader, tmp_path):
    """A daemon of one package writes its snapshot mid-epoch; a daemon of
    the other restores it to the same state dict, and the client's stream
    resumes there bit-identically."""
    W_srv, W_cli, w_specs, _ = PACKAGES[writer]
    R_srv, R_cli, r_specs, _ = PACKAGES[reader]
    snap = str(tmp_path / "svc.json")
    spec = w_specs["mixture"](world=2)
    ref = np.asarray(spec.rank_indices(4, 1))
    srv = W_srv(spec, snapshot_path=snap, snapshot_interval=1)
    host, port = srv.start()
    with W_cli((host, port), rank=1, batch=23) as c:
        c.set_epoch(4)
        it = c.epoch_batches(4)
        head = [next(it) for _ in range(3)]
        state = c.state_dict()
    srv.stop()
    written = srv._state_dict()
    srv2 = R_srv(r_specs["mixture"](world=2), snapshot_path=snap)
    srv2.start()
    try:
        restored = srv2._state_dict()
        assert restored == written
        with R_cli(srv2.address, rank=1, batch=23) as c:
            c.load_state_dict(state)
            tail = list(c.resume_batches())
    finally:
        srv2.stop()
    assert np.array_equal(np.concatenate(head + tail), ref)
