"""Crash-consistent, segment-based write-ahead log.

One :class:`WriteAheadLog` holds a directory of segment files
(``wal-<first_lsn>.seg``); each record is one CRC32-framed entry::

    [ length:u32 | crc32(payload):u32 | payload (canonical JSON) ]

The frame is length-prefixed AND per-record checksummed, so a torn tail
— a partial final frame left by a crash mid-write — is *detected* on
open, logged, and cut (never silently replayed), and a flipped byte
anywhere in a frame fails its checksum instead of replaying garbage.

Design points:

* **Dense LSNs on disk.**  Records carry their ``lsn``; when an append
  is lost (an injected ``wal.append`` fault, a real ``ENOSPC``) the next
  successful append first writes ``noop`` filler frames for the missing
  lsns, so the on-disk sequence stays dense and recovery can assert it
  (:mod:`.recover`).  The lost transition itself is re-established by
  the next snapshot seal — durability degrades observably
  (``wal_append_errors``), serving never stops.
* **Fsync policies.**  ``per_record`` fsyncs every append (strongest,
  slowest); ``group_commit(max_ms, max_records)`` batches fsyncs until
  either bound trips (the default — bounded loss window, near-zero
  per-append cost); ``off`` never fsyncs (bench arms / throwaway runs).
* **Checkpoints bound the log.**  A snapshot seal calls
  :meth:`checkpoint` with the owner's watermark lsn; GC deletes whole
  segments below the *previous* watermark of every registered owner —
  two checkpoints of retention, so a restart whose newest snapshot is
  corrupt can fall back to the previous one and replay a longer tail
  (``snapshot_fallbacks``).  A segment at or above any owner's
  watermark floor is never deleted.
* **Fault sites.**  ``wal.append`` (``torn_frame`` leaves a real torn
  tail on disk and degrades the log; other kinds drop the record),
  ``wal.fsync`` (a failed fsync is counted, the data stays in the page
  cache), and ``wal.rotate`` (fired at segment rollover and at
  checkpoint GC — an injected fault there models a crash between the
  seal and the truncation: segments linger, recovery stays correct).
"""

from __future__ import annotations

import json
import os
import re
import struct
import time
import warnings
import zlib
from collections import deque
from typing import Optional

from .. import faults as F
from ..analysis.lockorder import new_lock

#: segment rollover threshold (bytes of framed records per segment)
DEFAULT_SEGMENT_BYTES = 1 << 20

#: frame header: payload length, payload crc32 (little endian)
_FRAME = struct.Struct("<II")

#: sanity bound on a single record's payload — a length field past this
#: is treated as corruption, not as a 4GB allocation
_MAX_RECORD = 64 << 20

_SEG_RE = re.compile(r"^wal-(\d{16})\.seg$")


def _seg_name(first_lsn: int) -> str:
    return f"wal-{first_lsn:016d}.seg"


def _encode(rec: dict) -> bytes:
    payload = json.dumps(rec, separators=(",", ":"),
                         sort_keys=True).encode("utf-8")
    return _FRAME.pack(len(payload), zlib.crc32(payload)) + payload


def iter_frames(data: bytes):
    """Yield ``(offset, payload)`` for every valid frame; stop at the
    first torn/corrupt one.  The caller learns the valid prefix length
    from the last yielded offset + its frame size."""
    off, n = 0, len(data)
    while off + _FRAME.size <= n:
        length, crc = _FRAME.unpack_from(data, off)
        if length > _MAX_RECORD or off + _FRAME.size + length > n:
            return
        payload = data[off + _FRAME.size:off + _FRAME.size + length]
        if zlib.crc32(payload) != crc:
            return
        yield off, payload
        off += _FRAME.size + length


class FsyncPolicy:
    """Parsed fsync policy: ``per_record`` / ``group_commit`` / ``off``.

    Accepts ``"per_record"``, ``"off"``, ``"group_commit"`` or
    ``"group_commit(max_ms, max_records)"`` — e.g.
    ``"group_commit(5, 64)"`` fsyncs when 64 records are pending or
    5 ms have passed since the last fsync, whichever trips first."""

    MODES = ("per_record", "group_commit", "off")

    def __init__(self, mode: str = "group_commit", *, max_ms: float = 5.0,
                 max_records: int = 64) -> None:
        if mode not in self.MODES:
            raise ValueError(f"fsync mode must be one of {self.MODES}, "
                             f"got {mode!r}")
        if max_ms < 0 or max_records < 1:
            raise ValueError(f"group_commit bounds must be max_ms >= 0 and "
                             f"max_records >= 1, got ({max_ms}, "
                             f"{max_records})")
        self.mode = mode
        self.max_ms = float(max_ms)
        self.max_records = int(max_records)

    @classmethod
    def parse(cls, value) -> "FsyncPolicy":
        if isinstance(value, FsyncPolicy):
            return value
        text = str(value).strip()
        m = re.fullmatch(r"group_commit\(\s*([0-9.]+)\s*,\s*(\d+)\s*\)",
                         text)
        if m:
            return cls("group_commit", max_ms=float(m.group(1)),
                       max_records=int(m.group(2)))
        return cls(text)

    def __repr__(self) -> str:
        if self.mode == "group_commit":
            return f"group_commit({self.max_ms:g}, {self.max_records})"
        return self.mode

    def __eq__(self, other) -> bool:
        return (isinstance(other, FsyncPolicy)
                and (self.mode, self.max_ms, self.max_records)
                == (other.mode, other.max_ms, other.max_records))


class WriteAheadLog:
    """Thread-safe segment WAL over ``wal_dir``.

    ``open()`` happens in the constructor: existing segments are
    scanned, a torn tail is truncated (``wal_torn_tails``), and
    ``last_lsn`` resumes from the last valid record.  ``metrics`` is an
    optional :class:`~..service.metrics.ServiceMetrics`; ``clock`` times
    the group-commit window (injectable for tests)."""

    def __init__(self, wal_dir: str, *, fsync="group_commit",
                 segment_bytes: int = DEFAULT_SEGMENT_BYTES,
                 metrics=None, clock=time.monotonic) -> None:
        self.wal_dir = str(wal_dir)
        self.policy = FsyncPolicy.parse(fsync)
        self.segment_bytes = max(_FRAME.size + 2, int(segment_bytes))
        self._metrics = metrics
        self._clock = clock
        self._lock = new_lock("durability.wal")
        #: ordered (first_lsn, path) of live segments, current one last
        self._segments: list = []      # guarded by: self._lock
        self._f = None                 # guarded by: self._lock — current segment handle
        self._good = 0                 # guarded by: self._lock — valid bytes in current segment
        self._pending = 0              # guarded by: self._lock — records since last fsync
        self._last_sync = clock()      # guarded by: self._lock
        self._written_lsn = 0          # guarded by: self._lock — last lsn actually framed
        #: per-owner checkpoint watermarks, newest-last, two retained —
        #: GC cuts at every owner's OLDER one (previous-checkpoint
        #: retention for the corrupt-snapshot fallback path)
        self._watermarks: dict = {}    # guarded by: self._lock
        self._degraded = False         # guarded by: self._lock — torn mid-file; appends stop
        self._warned = False           # guarded by: self._lock
        self.last_lsn = 0
        self.torn_bytes = 0
        os.makedirs(self.wal_dir, exist_ok=True)
        with self._lock:
            self._open_locked()

    # ------------------------------------------------------------- metrics
    def _count(self, name: str, value: int = 1) -> None:
        if self._metrics is not None:
            self._metrics.inc(name, value=value)

    def _observe_ms(self, name: str, ms: float) -> None:
        if self._metrics is not None:
            self._metrics.registry.histogram(name).observe(ms)

    # ------------------------------------------------------ open/scan/close
    def _open_locked(self) -> None:
        names = sorted(n for n in os.listdir(self.wal_dir)
                       if _SEG_RE.match(n))
        self._segments = [(int(_SEG_RE.match(n).group(1)),
                           os.path.join(self.wal_dir, n)) for n in names]
        cut_from: Optional[int] = None
        last_lsn = 0
        for i, (first, path) in enumerate(self._segments):
            with open(path, "rb") as f:
                data = f.read()
            good = 0
            for off, payload in iter_frames(data):
                good = off + _FRAME.size + len(payload)
                last_lsn = int(json.loads(payload).get("lsn", last_lsn))
            if good < len(data):
                # torn/corrupt frame: cut here; everything after it (the
                # remainder + any later segments) is unreadable by
                # construction and is dropped with it
                self.torn_bytes += len(data) - good
                os.truncate(path, good)
                self._count("wal_torn_tails")
                warnings.warn(
                    f"WriteAheadLog: torn tail in {path!r} — cut "
                    f"{len(data) - good} byte(s) at offset {good} "
                    f"(last valid lsn {last_lsn})", RuntimeWarning,
                )
                cut_from = i
                break
        if cut_from is not None:
            for first, path in self._segments[cut_from + 1:]:
                self.torn_bytes += os.path.getsize(path)
                os.unlink(path)
            self._segments = self._segments[:cut_from + 1]
        if self._segments:
            first, path = self._segments[-1]
            if os.path.getsize(path) == 0 and len(self._segments) > 1:
                # a fully-torn last segment: drop the empty shell and
                # keep appending to its predecessor
                os.unlink(path)
                self._segments.pop()
                first, path = self._segments[-1]
            self._f = open(path, "ab")
            self._good = os.path.getsize(path)
        self.last_lsn = self._written_lsn = last_lsn

    def close(self, sync: bool = True) -> None:
        with self._lock:
            f, self._f = self._f, None
            if f is None:
                return
            try:
                if sync and self.policy.mode != "off":
                    f.flush()
                    os.fsync(f.fileno())
                f.close()
            except OSError:
                pass

    # -------------------------------------------------------------- append
    def append(self, rec: dict) -> bool:
        """Frame and write one record (``rec['lsn']`` is the caller's —
        :class:`~..service.replication.ReplicationLog` assigns it).
        Returns False when the record was dropped (fault/disk error);
        never raises into the serving path except the injected
        thread-death kind, which must propagate by contract."""
        with self._lock:
            if self._degraded:
                self._count("wal_append_drops")
                return False
            rule = F.draw("wal.append")
            if rule is not None:
                return self._append_fault_locked(rule, rec)
            return self._write_record_locked(rec)

    def _append_fault_locked(self, rule, rec: dict) -> bool:
        self._count("wal_append_errors")
        if rule.kind == "thread_death":
            raise F.InjectedThreadDeath(
                f"injected thread death at wal.append (lsn "
                f"{rec.get('lsn')})")
        if rule.kind == "torn_frame":
            # leave a REAL torn tail on disk — exactly what a crash
            # mid-write leaves — and stop appending: frames written
            # after a torn one would be unreachable on recovery anyway
            frame = _encode(rec)
            try:
                if self._f is None:
                    self._open_segment_locked(int(rec["lsn"]))
                self._f.write(frame[:max(1, len(frame) // 2)])
                self._f.flush()
            except OSError:
                pass
            self._degraded = True
            self._warn_once_locked(
                f"injected torn frame at lsn {rec.get('lsn')}; WAL "
                "degraded — appends stop until restart")
            return False
        # disk_full / error / reset / corrupt / delay: the record is
        # simply lost; the next successful append writes a noop filler
        # for its lsn so the on-disk sequence stays dense
        return False

    def _write_record_locked(self, rec: dict) -> bool:
        lsn = int(rec["lsn"])
        first_lsn = min(lsn, self._written_lsn + 1)
        frames = b""
        # fill any holes left by dropped appends with noop records:
        # recovery asserts a dense lsn sequence, and a hole would
        # otherwise be indistinguishable from corruption
        for missing in range(self._written_lsn + 1, lsn):
            frames += _encode({"lsn": missing, "op": "noop"})
        frames += _encode(rec)
        if (self._f is not None
                and self._good + len(frames) > self.segment_bytes
                and self._good > 0):
            self._rotate_locked(first_lsn)
        if self._f is None:
            self._open_segment_locked(first_lsn)
        try:
            self._f.write(frames)
        except OSError as exc:
            self._truncate_back_locked()
            self._count("wal_append_errors")
            self._warn_once_locked(f"append failed ({exc!r})")
            return False
        self._good += len(frames)
        self._written_lsn = self.last_lsn = lsn
        self._pending += 1
        self._count("wal_appends")
        self._maybe_sync_locked()
        return True

    def _truncate_back_locked(self) -> None:
        """Best-effort cut back to the last fully-written frame after a
        failed write, so the partial bytes cannot corrupt the chain."""
        try:
            self._f.flush()
            os.ftruncate(self._f.fileno(), self._good)
            self._f.seek(0, os.SEEK_END)
        except OSError:
            self._degraded = True
            self._warn_once_locked("partial frame could not be cut; WAL "
                                   "degraded — appends stop until restart")

    def _warn_once_locked(self, detail: str) -> None:
        if not self._warned:
            self._warned = True
            warnings.warn(f"WriteAheadLog({self.wal_dir!r}): {detail}; "
                          "serving continues, durability is degraded "
                          "until the next snapshot seal", RuntimeWarning)

    def _open_segment_locked(self, first_lsn: int) -> None:
        path = os.path.join(self.wal_dir, _seg_name(first_lsn))
        self._f = open(path, "ab")
        self._good = os.path.getsize(path)
        self._segments.append((int(first_lsn), path))

    # -------------------------------------------------------------- fsync
    def sync(self) -> None:
        """Force an fsync now regardless of policy (``off`` included) —
        the final-snapshot/shutdown path."""
        with self._lock:
            self._sync_locked(force=True)

    def _maybe_sync_locked(self) -> None:
        p = self.policy
        if p.mode == "off":
            return
        if p.mode == "per_record":
            self._sync_locked()
            return
        if (self._pending >= p.max_records
                or (self._clock() - self._last_sync) * 1e3 >= p.max_ms):
            self._sync_locked()

    def _sync_locked(self, force: bool = False) -> None:
        if self._f is None:
            return
        try:
            F.fire("wal.fsync")
        except F.InjectedThreadDeath:
            raise
        except Exception:  # lint: allow-broad-except(injected fsync fault: data stays in the page cache, counted)
            self._count("wal_fsync_errors")
            if not force:
                return
        t0 = time.perf_counter()
        try:
            self._f.flush()
            os.fsync(self._f.fileno())
        except OSError as exc:
            self._count("wal_fsync_errors")
            self._warn_once_locked(f"fsync failed ({exc!r})")
            return
        self._observe_ms("wal_fsync_ms", (time.perf_counter() - t0) * 1e3)
        self._count("wal_fsyncs")
        self._pending = 0
        self._last_sync = self._clock()

    # ------------------------------------------------------------ rotation
    def _rotate_locked(self, next_lsn: int) -> None:
        try:
            F.fire("wal.rotate")
        except F.InjectedThreadDeath:
            raise
        except Exception:  # lint: allow-broad-except(injected rotate fault: keep appending to the full segment)
            self._count("wal_rotate_errors")
            return
        self._sync_locked()  # seal the finished segment before moving on
        f, self._f = self._f, None
        try:
            f.close()
        except OSError:
            pass
        self._open_segment_locked(next_lsn)
        self._count("wal_rotations")

    # ------------------------------------------------------------- reading
    def read_records(self, after_lsn: int = 0,
                     upto_lsn: Optional[int] = None) -> list:
        """Every record with ``after_lsn < lsn <= upto_lsn`` still on
        disk, in lsn order.  The shipper streams catch-up tails from
        here; recovery replays from here."""
        with self._lock:
            if self._f is not None:
                try:
                    self._f.flush()
                except OSError:
                    pass
            segments = list(self._segments)
        out = []
        for i, (first, path) in enumerate(segments):
            if i + 1 < len(segments) and \
                    segments[i + 1][0] <= after_lsn + 1:
                continue  # fully below the requested tail
            try:
                with open(path, "rb") as f:
                    data = f.read()
            except OSError:
                continue  # GC won the race; later segments still serve
            for _, payload in iter_frames(data):
                rec = json.loads(payload)
                lsn = int(rec.get("lsn", 0))
                if lsn <= after_lsn:
                    continue
                if upto_lsn is not None and lsn > upto_lsn:
                    return out
                out.append(rec)
        return out

    def segment_paths(self) -> list:
        with self._lock:
            return [p for _, p in self._segments]

    # -------------------------------------------------- checkpoints and GC
    def register_owner(self, owner: str) -> None:
        """Declare a checkpoint owner (the front server, each tenant).
        An owner with fewer than two recorded checkpoints pins the whole
        log — GC never cuts records a never-sealed owner might need."""
        with self._lock:
            self._watermarks.setdefault(str(owner), deque(maxlen=2))

    def checkpoint(self, owner: str, lsn: int) -> int:
        """Record ``owner``'s seal watermark and garbage-collect
        segments every owner has checkpointed past (previous-watermark
        retention).  Returns the number of segments deleted."""
        with self._lock:
            dq = self._watermarks.setdefault(str(owner), deque(maxlen=2))
            dq.append(int(lsn))
            return self._gc_locked()

    def watermark_floor(self) -> int:
        """The lsn GC may cut at: min over owners of each owner's
        *previous* checkpoint (0 while any owner has fewer than two)."""
        with self._lock:
            return self._floor_locked()

    def _floor_locked(self) -> int:
        if not self._watermarks:
            return 0
        return min((dq[0] if len(dq) == 2 else 0)
                   for dq in self._watermarks.values())

    def _gc_locked(self) -> int:
        floor = self._floor_locked()
        if floor <= 0 or len(self._segments) < 2:
            return 0
        deletable = []
        for i, (first, path) in enumerate(self._segments[:-1]):
            # segment i covers [first_i, first_{i+1} - 1]; delete only
            # when its LAST lsn is at or below the floor — a segment
            # holding any record above the watermark floor must survive
            if self._segments[i + 1][0] - 1 <= floor:
                deletable.append((i, path))
        if not deletable:
            return 0
        try:
            F.fire("wal.rotate")
        except F.InjectedThreadDeath:
            raise
        except Exception:  # lint: allow-broad-except(injected GC fault models a crash between seal and truncate)
            self._count("wal_rotate_errors")
            return 0
        for _, path in deletable:
            try:
                os.unlink(path)
            except OSError:
                pass
        drop = {i for i, _ in deletable}
        self._segments = [s for i, s in enumerate(self._segments)
                          if i not in drop]
        self._count("wal_segments_gced", value=len(deletable))
        return len(deletable)
