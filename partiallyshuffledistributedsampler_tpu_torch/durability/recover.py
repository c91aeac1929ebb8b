"""Crash recovery: checkpoint restore + WAL-tail replay.

A restarted ``IndexServer`` with a ``wal_dir`` recovers in three steps
(docs/RESILIENCE.md "Durability & recovery"):

1. the newest snapshot checkpoint is loaded (falling back to the
   previous one when its CRC fails — ``snapshot_fallbacks``), which
   stamps ``_ckpt_lsn``, the WAL position the snapshot already
   reflects;
2. the WAL is opened, which detects and cuts any torn tail;
3. :func:`replay_wal_tail` replays every surviving record above each
   owner's checkpoint watermark into the engine through the same
   ``_apply_record_locked`` path a hot standby uses, after
   :func:`check_invariants` has vetted the tail (dense LSNs, cursor
   monotonicity, legal barrier states) — a tail that fails its
   invariants raises :class:`RecoveryError` instead of half-applying.

Recovery cost is bounded by the tail length, never the snapshot size;
``recovery_replay_ms`` and ``wal_recoveries`` make that observable.
:func:`truncate_wal_copy` is the kill-at-any-byte harness: it clones a
recorded WAL cut at an arbitrary byte offset, so tests can recover from
every possible crash point of a real run.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

from .. import telemetry
from .wal import _FRAME, _SEG_RE, iter_frames


class RecoveryError(RuntimeError):
    """The WAL tail violated a recovery invariant (see
    :func:`check_invariants`); the state must not be half-applied."""


def check_invariants(records) -> None:
    """Vet a WAL tail before replay.  Raises :class:`RecoveryError` on:

    * a **non-dense LSN sequence** — the WAL writes noop fillers for
      dropped appends, so any hole left is corruption, not loss;
    * a **cursor regression** — within one epoch a ``(tenant, rank)``
      cursor's ``acked``/``hi``/``samples`` watermarks only advance
      (an epoch change resets them);
    * an **illegal barrier state** — a replicated reshard must carry
      its full shape and its drained set must be a subset of its
      participants.
    """
    prev_lsn: Optional[int] = None
    cursors: dict = {}
    for rec in records:
        lsn = int(rec.get("lsn", 0))
        if prev_lsn is not None and lsn != prev_lsn + 1:
            raise RecoveryError(
                f"non-dense lsn sequence: {prev_lsn} -> {lsn} (a hole "
                "the noop fillers should have closed — corrupt tail)")
        prev_lsn = lsn
        op = rec.get("op")
        if op == "cursor":
            key = (rec.get("tenant"), int(rec["rank"]))
            cur = {"epoch": int(rec["epoch"]), "acked": int(rec["acked"]),
                   "hi": int(rec["hi"]), "samples": int(rec["samples"])}
            last = cursors.get(key)
            if last is not None and last["epoch"] == cur["epoch"]:
                for k in ("acked", "hi", "samples"):
                    if cur[k] < last[k]:
                        raise RecoveryError(
                            f"cursor regression at lsn {lsn}: rank "
                            f"{key[1]} {k} {last[k]} -> {cur[k]} within "
                            f"epoch {cur['epoch']}")
            cursors[key] = cur
        elif op == "state":
            rs = (rec.get("state") or {}).get("reshard")
            if rs is not None:
                _check_reshard(lsn, rs)


def _check_reshard(lsn: int, rs: dict) -> None:
    for k in ("target_world", "epoch", "barrier_units", "targets",
              "drained"):
        if k not in rs:
            raise RecoveryError(
                f"reshard record at lsn {lsn} is missing {k!r}")
    if int(rs["target_world"]) < 1 or int(rs["barrier_units"]) < 0:
        raise RecoveryError(
            f"reshard record at lsn {lsn} has illegal shape: "
            f"target_world={rs['target_world']} "
            f"barrier_units={rs['barrier_units']}")
    targets = {int(r) for r in rs["targets"]}
    drained = {int(r) for r in rs["drained"]}
    if not drained <= targets:
        raise RecoveryError(
            f"reshard record at lsn {lsn} drained ranks "
            f"{sorted(drained - targets)} that are not barrier "
            "participants")


def replay_wal_tail(server, *, upto_lsn: Optional[int] = None) -> dict:
    """Replay ``server._wal``'s tail above each owner's checkpoint into
    the (unstarted or restarting) server.  Point-in-time recovery stops
    at ``upto_lsn`` when given.  Returns a stats dict
    (``replayed``/``skipped``/``last_lsn``/``replay_ms``)."""
    wal = getattr(server, "_wal", None)
    stats = {"replayed": 0, "skipped": 0, "last_lsn": 0, "replay_ms": 0.0}
    if wal is None:
        return stats
    t0 = time.perf_counter()
    with telemetry.span("wal_recover", wal_dir=wal.wal_dir):
        # read above the lowest owner watermark, then gate per record on
        # ITS owner's watermark — one tenant's older checkpoint must not
        # re-apply another's already-snapshotted transitions
        floor = min([int(server._ckpt_lsn)]
                    + [int(eng._ckpt_lsn)
                       for eng in server._tenant_by_id.values()])
        records = wal.read_records(after_lsn=max(0, floor),
                                   upto_lsn=upto_lsn)
        check_invariants(records)
        for rec in records:
            lsn = int(rec.get("lsn", 0))
            tid = rec.get("tenant")
            eng = (server._tenant_by_id.get(str(tid))
                   if tid is not None else None)
            owner_ckpt = int(eng._ckpt_lsn if eng is not None
                             else server._ckpt_lsn)
            if lsn <= owner_ckpt:
                stats["skipped"] += 1
                continue
            with server._lock:
                server._apply_record_locked(rec)
            stats["replayed"] += 1
            stats["last_lsn"] = lsn
        # seal records replayed from the tail must not trigger snapshot
        # writes mid-recovery; the restart path snapshots once at the end
        server._seal_pending = False
        for eng in server._tenant_by_id.values():
            eng._seal_pending = False
    ms = (time.perf_counter() - t0) * 1e3
    stats["replay_ms"] = ms
    server.metrics.inc("wal_recoveries")
    server.metrics.registry.histogram("recovery_replay_ms").observe(ms)
    telemetry.event("wal_recovered", replayed=stats["replayed"],
                    skipped=stats["skipped"], last_lsn=stats["last_lsn"])
    return stats


def recover_unstarted(server) -> dict:
    """Run the full restart-time recovery (snapshot restore, torn-tail
    cut, tail replay) on a server that has NOT been started — no socket
    is bound, no threads spawn.  The crash matrix uses this to vet every
    truncation offset cheaply; ``start()`` runs the same sequence."""
    if server._listener is not None:
        raise RuntimeError("recover_unstarted() needs an unstarted server")
    return server._recover_from_disk()


def wal_total_bytes(wal_dir: str) -> int:
    """Total on-disk bytes across the directory's WAL segments — the
    crash matrix iterates truncation offsets over this range."""
    try:
        names = os.listdir(wal_dir)
    except OSError:
        return 0
    return sum(os.path.getsize(os.path.join(wal_dir, n))
               for n in sorted(names) if _SEG_RE.match(n))


def truncate_wal_copy(src_dir: str, dst_dir: str, nbytes: int) -> int:
    """Clone ``src_dir``'s WAL into ``dst_dir`` cut at exactly
    ``nbytes`` (cumulative across segments in lsn order) — the on-disk
    state a kill at that byte would have left.  Returns bytes copied."""
    os.makedirs(dst_dir, exist_ok=True)
    budget = max(0, int(nbytes))
    copied = 0
    for name in sorted(os.listdir(src_dir)):
        if not _SEG_RE.match(name):
            continue
        if copied >= budget and copied > 0:
            break
        with open(os.path.join(src_dir, name), "rb") as f:
            data = f.read()
        take = min(len(data), budget - copied)
        if take <= 0 and copied > 0:
            break
        with open(os.path.join(dst_dir, name), "wb") as f:
            f.write(data[:take])
        copied += take
    return copied


def last_valid_lsn(wal_dir: str) -> int:
    """The last lsn a recovery of ``wal_dir`` as-is would see (torn
    tail excluded) — what the crash matrix compares resumed streams
    against."""
    last = 0
    for name in sorted(os.listdir(wal_dir)):
        if not _SEG_RE.match(name):
            continue
        with open(os.path.join(wal_dir, name), "rb") as f:
            data = f.read()
        good = 0
        for off, payload in iter_frames(data):
            last = int(json.loads(payload).get("lsn", last))
            good = off + _FRAME.size + len(payload)
        if good < len(data):
            break  # torn here: later segments are unreachable
    return last


def read_autopilot_records(wal_dir: str) -> list:
    """Every ``autopilot`` decision record still on disk under
    ``wal_dir``, in lsn order — the WAL-logged decision history
    ``autopilot.learn_priors`` rebuilds warm-start priors from, and
    the live half of the sim/real trace parity comparison
    (docs/SIMULATOR.md "WAL parity").  A standalone reader: no server,
    no lock, torn tails simply end the scan the way recovery would."""
    out = []
    for name in sorted(os.listdir(wal_dir)):
        if not _SEG_RE.match(name):
            continue
        with open(os.path.join(wal_dir, name), "rb") as f:
            data = f.read()
        good = 0
        for off, payload in iter_frames(data):
            rec = json.loads(payload)
            if rec.get("op") == "autopilot":
                out.append(rec)
            good = off + _FRAME.size + len(payload)
        if good < len(data):
            break  # torn here: later segments are unreachable
    out.sort(key=lambda r: int(r.get("lsn", 0)))
    return out
