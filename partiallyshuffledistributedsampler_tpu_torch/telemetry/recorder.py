"""Flight recorder: a bounded ring of recent spans/events + JSONL dumps.

The recorder is the black box of the served-index stack.  Every finished
span and structured event lands in a lock-protected ``deque(maxlen=…)``;
when something goes wrong — a fault injection fires, the prefetch
watchdog raises ``StallError``, a reshard barrier aborts — the ring (plus
every still-open span) is written out as one JSONL file so the failure
comes with a reconstructable timeline instead of a bare counter bump.

Entries are already redacted at record time (see ``trace._scrub``): ids,
names, small attributes and durations only — never index payloads.
Dumps are rate-limited by ``max_dumps`` per recorder lifetime so a fault
storm cannot fill a disk.
"""

from __future__ import annotations

import json
import os
import re
import time
from collections import deque
from typing import Optional
from ..analysis.lockorder import new_lock
from .trace import jsonable, resolve


class FlightRecorder:
    """Bounded in-memory ring of telemetry entries with JSONL dumps.

    ``capacity`` bounds the ring (oldest entries fall off); ``dump_dir``
    is where automatic dumps are written (``None`` disables them);
    ``max_dumps`` caps files written per recorder lifetime; ``sink`` is
    an optional live exporter (e.g. :class:`~.export.JsonlSink`) that
    receives every entry as it is recorded; ``clock`` is the wall-clock
    source stamped on dump metadata and filenames (injectable so tests
    can pin dump timestamps)."""

    def __init__(self, capacity: int = 1024, dump_dir: Optional[str] = None,
                 max_dumps: int = 16, sink=None,
                 clock=time.time) -> None:
        self._lock = new_lock("telemetry.recorder")
        self._ring: deque = deque(maxlen=max(1, int(capacity)))
        self.dump_dir = dump_dir
        self.max_dumps = int(max_dumps)
        self.sink = sink
        self.clock = clock
        self._dump_seq = 0  # guarded by: self._lock
        self.dropped = 0  # guarded by: self._lock — entries pushed out

    # ------------------------------------------------------------ recording
    def record(self, entry: dict) -> None:
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(entry)
        sink = self.sink
        if sink is not None:
            try:
                sink.write(entry)
            except Exception:  # lint: allow-broad-except(a broken exporter must never take down the data path)
                pass

    def snapshot(self, limit: Optional[int] = None, *,
                 wait: bool = True) -> list[dict]:
        """Most-recent-last copy of the ring (optionally the last
        ``limit`` entries) — what the TRACE_DUMP RPC returns.  A span's
        device interval is resolved here, once: the entry keeps the
        number.  ``wait=False`` leaves one the device has not reached
        pending instead of waiting for it."""
        with self._lock:
            out = list(self._ring)
        if limit is not None and limit > 0:
            out = out[-int(limit):]
        for e in out:
            resolve(e, wait)
        return out

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dropped = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    # -------------------------------------------------------------- dumping
    def dump(self, path: str, *, reason: str = "manual",
             extra_entries=()) -> str:
        """Write the ring + ``extra_entries`` (typically open spans) to
        ``path`` as JSONL.  First line is a metadata record.  A dump never
        waits for the device (it may be what hung): a device interval not
        reached yet is written as null."""
        entries = self.snapshot(wait=False)
        extra_entries = list(extra_entries)
        with self._lock:
            self._dump_seq += 1
            seq = self._dump_seq
            dropped = self.dropped
        lines = [json.dumps({
            "kind": "flight_dump", "reason": str(reason), "seq": seq,
            "wall": round(self.clock(), 3), "entries": len(entries),
            "open_spans": len(extra_entries), "dropped": dropped,
        }, separators=(",", ":"))]
        for e in entries:
            lines.append(json.dumps(e, separators=(",", ":"),
                                    default=jsonable))
        for e in extra_entries:
            lines.append(json.dumps(e, separators=(",", ":"),
                                    default=jsonable))
        # the same atomic write+fsync path the snapshots use: a
        # post-mortem written milliseconds before the host dies must
        # actually survive it, not sit in the page cache.  Deferred
        # import: utils.retry imports telemetry, so a module-level one
        # would be circular
        from ..utils.checkpoint import durable_write_text
        durable_write_text(path, "\n".join(lines) + "\n")
        return path

    def auto_dump(self, reason: str, extra_entries=()) -> Optional[str]:
        """Dump into ``dump_dir`` if configured and under the
        ``max_dumps`` budget; returns the path or ``None``."""
        d = self.dump_dir
        if d is None:
            return None
        with self._lock:
            if self._dump_seq >= self.max_dumps:
                return None
        os.makedirs(d, exist_ok=True)
        slug = re.sub(r"[^A-Za-z0-9._-]+", "_", str(reason))[:64] or "dump"
        name = f"flight-{int(self.clock() * 1e3):013d}-{slug}.jsonl"
        try:
            return self.dump(os.path.join(d, name), reason=reason,
                             extra_entries=extra_entries)
        except OSError:
            return None  # a full/readonly disk must not break the data path
