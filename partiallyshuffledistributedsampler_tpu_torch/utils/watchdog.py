"""Prefetch watchdog: a hung pipeline must surface a typed error.

A background gather thread that dies silently (or wedges in a gather)
leaves its consumer blocked on a queue forever — the worst failure mode a
data pipeline has, because nothing ever reports it.  The loader's
consumer loop polls its queue with a timeout and, when the producer's
progress timestamp goes stale past the deadline (or the thread is simply
dead without having delivered a result), raises :class:`StallError`
carrying the stuck thread's current stack — turning "the job hangs" into
a typed, attributable exception.
"""

from __future__ import annotations

import sys
import threading
import traceback
from typing import Optional


def thread_stack(thread: Optional[threading.Thread]) -> Optional[str]:
    """The thread's current Python stack, or None when it has none (not
    started, already dead, or not a Python thread)."""
    if thread is None or thread.ident is None:
        return None
    frame = sys._current_frames().get(thread.ident)
    if frame is None:
        return None
    return "".join(traceback.format_stack(frame))


class StallError(RuntimeError):
    """The prefetch pipeline stopped making progress.

    ``thread_name`` names the stalled producer; when the thread was still
    alive at raise time the message embeds its stack, so the consumer's
    traceback shows *where* the producer is stuck, not just that it is.
    """

    def __init__(self, message: str,
                 thread: Optional[threading.Thread] = None) -> None:
        self.thread_name = thread.name if thread is not None else None
        self.thread_alive = thread.is_alive() if thread is not None else None
        stack = thread_stack(thread)
        if stack:
            message = (f"{message}\n--- stack of stalled thread "
                       f"{self.thread_name!r} ---\n{stack}")
        elif thread is not None:
            message = (f"{message} (thread {self.thread_name!r} is dead; "
                       "no stack available)")
        super().__init__(message)
        # a stall is one of the flight recorder's dump triggers
        # (docs/OBSERVABILITY.md); no-op unless telemetry is on with a
        # dump_dir, and never allowed to break the error itself
        try:
            from ..telemetry import auto_dump
            auto_dump("stall", thread=self.thread_name,
                      alive=self.thread_alive)
        except Exception:  # lint: allow-broad-except(observability is best-effort here)
            pass
