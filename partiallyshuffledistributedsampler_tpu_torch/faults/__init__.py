"""Deterministic fault injection for the served-index stack.

A copy of the JAX package's ``faults/`` with its own armed-plan stack:
the same plan fires at the same hits in both packages, and
``PSDS_FAULT_PLAN`` arms a plan in each.  :data:`SITES` names every site
of the JAX package, the service ones included; in this package the
loader's and the sampling sites consult it.

The sampler's contract — ``(seed, epoch)`` pins every rank's stream with
no inter-rank communication — makes every failure *recoverable by
recomputation*: any component can die and the stream is reconstructible
bit-identically.  This subsystem makes those failures **injectable and
repeatable** so the recovery paths run in CI instead of only in incident
reviews.

Vocabulary:

* A **fault site** is a named point in the stack that consults the
  framework (:data:`SITES`): ``service.send`` / ``service.recv`` (the
  client's wire ops), ``server.dispatch`` (one request on a serve
  thread), ``server.snapshot_write`` (the daemon's snapshot persist),
  ``server.reshard`` (an elastic barrier freezing / committing),
  ``client.leave`` (a client announcing its preemption drain),
  ``client.pipeline`` (the pipelined client topping up its lookahead
  window), ``loader.prefetch`` (one step of the gather thread),
  ``loader.regen`` (local epoch index generation), ``loader.boundary``
  (the epoch-boundary prefetch worker), ``capability.issue`` /
  ``capability.verify`` (the daemon signing, and a client admitting, a
  signed epoch capability — docs/CAPABILITY.md).
* A **fault kind** is what happens when a rule fires (:data:`KINDS`):
  ``reset`` (connection reset), ``delay`` (sleep ``delay_s``),
  ``torn_frame`` (half a frame hits the wire, then reset), ``corrupt``
  (a payload byte is flipped — the CRC32 checksum path must catch it),
  ``thread_death`` (the thread dies silently — the watchdog must catch
  it), ``disk_full`` (``OSError(ENOSPC)``), ``error`` (a generic typed
  :class:`InjectedFault`).
* A :class:`FaultRule` says *when* a site fires (``nth`` hit, ``every``
  period, ``count`` cap, or seeded probability ``p``); a
  :class:`FaultPlan` is an ordered set of rules armed as a context
  manager::

      with FaultPlan([FaultRule("service.recv", "corrupt", nth=2)]):
          stream = client.epoch_indices(epoch)   # must still be exact

  or process-wide via the ``PSDS_FAULT_PLAN`` env var (JSON, same
  fields) — so chaos runs need no monkeypatching anywhere.

Determinism: matching is driven by per-site hit counters (and, for
``p``-rules, a ``random.Random(seed)`` private to the plan), so a chaos
test replays the identical fault sequence on every run.

The instrumented production code pays one global ``is None`` check per
site when no plan is armed (:func:`draw`).
"""

from .plan import KINDS, SITES, FaultPlan, FaultRule  # noqa: F401
from .runtime import (  # noqa: F401
    InjectedFault,
    InjectedThreadDeath,
    active,
    apply_to_frame,
    arm,
    disarm,
    draw,
    fire,
    flip_byte,
    perform,
)
