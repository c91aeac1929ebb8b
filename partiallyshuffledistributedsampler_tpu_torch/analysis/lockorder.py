"""Runtime concurrency sanitizer: lock-order graph + thread-leak detector.

A copy of the JAX package's ``analysis/lockorder.py`` (pure standard
library), so the locks of this package are tracked by a graph of its own.
The loader's boundary lock, the sampling spec's dedup lock, the tracer's,
the flight recorder's, the fault runtime's and the metrics' locks are all
made here:

* :func:`new_lock` is the package's lock factory.  Off (the default) it
  returns a raw ``threading.Lock`` after a single flag check — zero
  steady-state cost, the same trick as the tracer's ``NULL_SPAN``.
  Under ``PSDS_SANITIZE=1`` (or after :func:`enable`) it returns a
  :class:`TrackedLock` that maintains a per-thread held-lock stack and a
  process-wide acquisition-order graph.
* Acquiring lock B while holding lock A records the edge ``A → B``
  (first observation keeps the acquiring stack).  If B can already reach
  A through recorded edges, that acquisition closes a cycle — a
  *potential deadlock* even if the schedules never collided in this run
  — and a violation report naming both conflicting acquisition stacks
  is recorded (:func:`violations`).
* The graph is keyed by lock *instance*, not name: two objects of one
  class whose locks deliberately nest would otherwise read as a
  self-cycle.
* :class:`TrackedLock` stays compatible with ``threading.Condition``:
  CPython's Condition falls back to plain ``acquire``/``release`` (and a
  nonblocking-acquire ``_is_owned`` probe) when the lock lacks
  ``_release_save``/``_acquire_restore``, so ``Condition(new_lock(...))``
  keeps the bookkeeping exact across ``wait()``.
* :func:`thread_snapshot` / :func:`leaked_threads` / :func:`thread_stacks`
  are the thread-leak detector.

Dependency-free by design (stdlib only): every module in the package
creates its locks through :func:`new_lock` without import cycles.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from typing import Iterable, List, Optional

__all__ = [
    "new_lock", "enable", "disable", "is_enabled", "reset",
    "TrackedLock", "violations", "render_violations", "stats",
    "thread_snapshot", "leaked_threads", "thread_stacks",
]

_ON = ("1", "true", "yes", "on")

#: frames of traceback kept per recorded edge (enough to name the
#: acquiring call site and its callers without storing whole stacks)
_STACK_DEPTH = 16

#: edges kept before the graph stops recording new ones (a runaway test
#: session must degrade to "no new observations", never to OOM)
_MAX_EDGES = 100_000


class _State:
    """Process-global sanitizer state (module-private singleton)."""

    def __init__(self) -> None:
        self.enabled = os.environ.get(
            "PSDS_SANITIZE", "").strip().lower() in _ON
        # a RAW lock (never a TrackedLock): leaf-level, guards everything
        # below, and must not observe itself
        self.mu = threading.Lock()
        self.next_id = 0          # guarded by: mu
        self.names: dict = {}     # guarded by: mu — lock id -> name
        self.edges: dict = {}     # guarded by: mu — (a, b) -> acquiring stack
        self.succ: dict = {}      # guarded by: mu — a -> set of b
        self.violations: list = []  # guarded by: mu
        self.tls = threading.local()  # .held: [(lock_id, name)]


_STATE = _State()


def is_enabled() -> bool:
    return _STATE.enabled


def enable() -> None:
    """Turn the sanitizer on for locks created *from now on* (existing
    raw locks stay raw — enable before building the objects under test)."""
    _STATE.enabled = True


def disable() -> None:
    _STATE.enabled = False


def reset() -> None:
    """Drop the recorded graph and violations (tests isolate with this)."""
    with _STATE.mu:
        _STATE.edges.clear()
        _STATE.succ.clear()
        _STATE.violations.clear()


def stats() -> dict:
    with _STATE.mu:
        return {
            "locks": _STATE.next_id,
            "edges": len(_STATE.edges),
            "violations": len(_STATE.violations),
        }


def _capture_stack() -> str:
    # drop the two innermost frames (this helper + _note_acquire); the
    # visible tail is the user's acquire call site
    return "".join(traceback.format_stack(limit=_STACK_DEPTH)[:-2])


def _reaches(src: int, dst: int) -> Optional[List[int]]:
    """Path src → dst over the recorded edges, or None (caller holds mu)."""
    stack = [(src, [src])]
    seen = {src}
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        for nxt in _STATE.succ.get(node, ()):
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _note_acquire(lock: "TrackedLock", held: list) -> None:
    """Slow path: this thread already holds other locks — record the
    order edges.  (The common held-nothing acquire never gets here.)"""
    new_edges = [(hid, lock._id) for hid, _ in held
                 if (hid, lock._id) not in _STATE.edges]
    if new_edges:
        stack = _capture_stack()
        with _STATE.mu:
            for a, b in new_edges:
                if (a, b) in _STATE.edges or len(_STATE.edges) >= _MAX_EDGES:
                    continue
                # does acquiring b while holding a close a cycle?
                # (b already reaches a through recorded edges)
                path = _reaches(b, a)
                _STATE.edges[(a, b)] = stack
                _STATE.succ.setdefault(a, set()).add(b)
                if path is not None:
                    other = _STATE.edges.get((path[0], path[1]), "")
                    _STATE.violations.append({
                        "cycle": [_STATE.names.get(n, f"lock#{n}")
                                  for n in [a] + path],
                        "this_edge": (_STATE.names.get(a, f"lock#{a}"),
                                      _STATE.names.get(b, f"lock#{b}")),
                        "this_stack": stack,
                        "other_edge": (
                            _STATE.names.get(path[0], f"lock#{path[0]}"),
                            _STATE.names.get(path[1], f"lock#{path[1]}"),
                        ),
                        "other_stack": other,
                        "thread": threading.current_thread().name,
                    })
    held.append((lock._id, lock.name))


class TrackedLock:
    """A ``threading.Lock`` wrapper feeding the acquisition-order graph.

    Not reentrant (neither is the lock it wraps).  Safe to hand to
    ``threading.Condition`` — CPython's fallback paths route ``wait()``'s
    release/re-acquire through this wrapper, keeping the held-set exact.
    """

    __slots__ = ("_lock", "name", "_id")

    def __init__(self, name: str) -> None:
        self._lock = threading.Lock()
        self.name = str(name)
        with _STATE.mu:
            _STATE.next_id += 1
            self._id = _STATE.next_id
            _STATE.names[self._id] = self.name

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        # Hot path stays flat: one tls fetch, and the graph machinery only
        # runs when this thread already holds something (nested acquire).
        got = self._lock.acquire(blocking, timeout)
        if got:
            tls = _STATE.tls
            held = getattr(tls, "held", None)
            if held is None:
                held = tls.held = []
            if held:
                _note_acquire(self, held)
            else:
                held.append((self._id, self.name))
        return got

    def release(self) -> None:
        held = getattr(_STATE.tls, "held", None)
        if held:
            if held[-1][0] == self._id:  # LIFO release: the common case
                held.pop()
            else:
                for i in range(len(held) - 1, -1, -1):
                    if held[i][0] == self._id:
                        del held[i]
                        break
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<TrackedLock {self.name!r} locked={self.locked()}>"


def new_lock(name: str):
    """The package's lock factory.

    Sanitizer off (default): a raw ``threading.Lock`` — the only cost is
    this one flag check, paid at *creation*, never per acquire.  On: a
    :class:`TrackedLock` wired into the order graph under ``name``
    (a stable dotted role like ``"server.front"``; instances of the same
    role are distinct graph nodes, the name is for reports)."""
    if not _STATE.enabled:
        return threading.Lock()
    return TrackedLock(name)


def violations() -> list:
    """Copies of every potential-deadlock report recorded so far."""
    with _STATE.mu:
        return [dict(v) for v in _STATE.violations]


def render_violations(reports: Optional[Iterable[dict]] = None) -> str:
    """Human-readable rendering of cycle reports, both stacks included."""
    if reports is None:
        reports = violations()
    out = []
    for v in reports:
        out.append(
            "potential deadlock: lock-order cycle "
            + " -> ".join(v["cycle"])
            + f" (thread {v['thread']})\n"
            + f"  edge {v['this_edge'][0]} -> {v['this_edge'][1]} "
            + "acquired at:\n"
            + "".join(f"    {ln}\n" for ln in v["this_stack"].splitlines())
            + f"  conflicting edge {v['other_edge'][0]} -> "
            + f"{v['other_edge'][1]} was acquired at:\n"
            + "".join(f"    {ln}\n" for ln in v["other_stack"].splitlines())
        )
    return "\n".join(out)


# ------------------------------------------------------ thread-leak detector
def thread_snapshot() -> frozenset:
    """Identities of the threads alive right now (fixture baseline)."""
    return frozenset(t.ident for t in threading.enumerate())


def leaked_threads(baseline: frozenset, *, grace_s: float = 2.0,
                   poll_s: float = 0.02,
                   include_daemon: bool = False) -> list:
    """Threads alive beyond ``baseline`` after a grace period.

    Polls until every new thread has exited or ``grace_s`` elapses —
    orderly teardown (a ``stop()`` that joins with a timeout) gets the
    benefit of the doubt; whatever survives is returned.  Daemon threads
    are excluded by default: the package's background workers are all
    daemonized by design, and the *assertion* target is the non-daemon
    stragglers that would hang interpreter exit."""
    deadline = time.monotonic() + max(0.0, grace_s)
    while True:
        leaked = [
            t for t in threading.enumerate()
            if t.ident not in baseline and t.is_alive()
            and (include_daemon or not t.daemon)
        ]
        if not leaked or time.monotonic() >= deadline:
            return leaked
        time.sleep(poll_s)


def thread_stacks(threads: Iterable[threading.Thread]) -> dict:
    """``{thread name: formatted stack}`` for live threads — what the
    leak fixture prints so a leak report shows *where* the thread is
    stuck, not just that it exists."""
    frames = sys._current_frames()
    out = {}
    for t in threads:
        frame = frames.get(t.ident)
        out[t.name] = ("".join(traceback.format_stack(frame))
                       if frame is not None else "<no frame>")
    return out
