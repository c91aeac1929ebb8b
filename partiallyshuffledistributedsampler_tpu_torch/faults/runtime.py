"""The armed-plan registry and the fault *actions* the sites apply.

The production hot path pays exactly one module-global ``is None`` check
per site visit (:func:`draw`); everything else runs only under an armed
plan.  The env-var plan (``PSDS_FAULT_PLAN``) is parsed lazily on the
first visited site, so merely importing the package never touches the
environment.
"""

from __future__ import annotations

import errno
import time
from typing import Optional

from .plan import FaultPlan, FaultRule
from ..analysis.lockorder import new_lock


class InjectedFault(RuntimeError):
    """A deliberately injected failure (kind='error' or a kind fired at a
    site that has no richer interpretation for it)."""

    def __init__(self, rule: FaultRule) -> None:
        super().__init__(f"injected fault: {rule.kind} at {rule.site}")
        self.site, self.kind = rule.site, rule.kind


class InjectedThreadDeath(BaseException):
    """Kills the current thread *silently*: deliberately NOT an
    ``Exception`` subclass, so ``except Exception`` error-delivery paths
    cannot convert it into a reported error — the thread simply stops,
    which is exactly the failure watchdogs exist to catch."""


_lock = new_lock("faults.runtime")
_stack: list[FaultPlan] = []
_env_checked = False


def arm(plan: FaultPlan) -> None:
    with _lock:
        _stack.append(plan)


def disarm(plan: FaultPlan) -> None:
    with _lock:
        if plan in _stack:
            _stack.remove(plan)


def active() -> Optional[FaultPlan]:
    """The innermost armed plan (env-var plan arms itself on first use)."""
    global _env_checked
    if not _stack:
        if _env_checked:
            return None
        with _lock:
            if not _env_checked:
                _env_checked = True
                env_plan = FaultPlan.from_env()
                if env_plan is not None:
                    _stack.append(env_plan)
        if not _stack:
            return None
    return _stack[-1]


def draw(site: str) -> Optional[FaultRule]:
    """Count one hit at ``site`` against the active plan; the cheap
    no-plan fast path every instrumented call goes through.

    A rule that fires is a flight-recorder dump trigger
    (docs/OBSERVABILITY.md): the event + dump land BEFORE the fault's
    effect is applied, so the dump shows the spans that were open when
    the fault hit.  Both are no-ops unless telemetry is enabled."""
    plan = active()
    if plan is None:
        return None
    rule = plan.draw(site)
    if rule is not None:
        # lazy import: the fault runtime stays importable standalone and
        # pays nothing on the (plan-armed but not firing) path
        from ..telemetry import auto_dump, event
        event("fault_injected", site=rule.site, kind=rule.kind)
        auto_dump(f"fault.{rule.site}", kind=rule.kind)
    return rule


def perform(rule: FaultRule) -> None:
    """Apply a control-kind rule: sleep or raise.  Byte-stream kinds
    (``torn_frame``/``corrupt``) degrade to :class:`InjectedFault` here —
    wire sites apply them through :func:`apply_to_frame`/:func:`flip_byte`
    instead."""
    if rule.kind == "delay":
        time.sleep(rule.delay_s)
        return
    if rule.kind == "reset":
        raise ConnectionResetError(f"injected reset at {rule.site}")
    if rule.kind == "thread_death":
        raise InjectedThreadDeath(f"injected thread death at {rule.site}")
    if rule.kind == "disk_full":
        raise OSError(errno.ENOSPC,
                      f"injected disk-full at {rule.site}")
    raise InjectedFault(rule)


def fire(site: str) -> None:
    """draw + perform for control sites (dispatch/snapshot/prefetch/regen)."""
    rule = draw(site)
    if rule is not None:
        perform(rule)


def flip_byte(data: bytes, offset: int = -1) -> bytes:
    """One flipped bit at ``offset`` — the minimal corruption a checksum
    must catch.  Empty input passes through (nothing to corrupt)."""
    if not data:
        return data
    buf = bytearray(data)
    buf[offset] ^= 0x01
    return bytes(buf)


def apply_to_frame(rule: FaultRule, sock, frame: bytes) -> bytes:
    """Interpret a rule against an outbound frame.

    ``torn_frame`` puts the first half on the wire and then resets (the
    peer sees a mid-frame close; the sender's retry layer sees a
    ``ConnectionResetError``); ``corrupt`` flips the frame's final byte
    (the tail of the JSON header or the payload — either way the peer's
    parser or checksum must reject it); the control kinds behave as in
    :func:`perform`."""
    if rule.kind == "torn_frame":
        try:
            sock.sendall(frame[:max(1, len(frame) // 2)])
        except OSError:
            pass  # the peer may already be gone; the reset below stands
        raise ConnectionResetError(f"injected torn frame at {rule.site}")
    if rule.kind == "corrupt":
        return flip_byte(frame)
    perform(rule)
    return frame
