"""The runtime concurrency sanitizer: lock-order graph and thread-leak
detector (:mod:`.lockorder`).

The JAX package's ``analysis/`` has two halves; this package carries the
runtime one, a copy of the JAX package's ``analysis/lockorder.py``: an
instrumented lock factory with a process-wide lock-acquisition-order graph
(potential-deadlock cycle reports naming both acquisition stacks) and a
thread-leak detector, enabled under ``PSDS_SANITIZE=1`` and zero-cost when
off (``new_lock`` hands back a raw ``threading.Lock`` after one flag
check).  The static half (the AST lints of ``analysis/lint.py`` and the
``python -m ...analysis`` CLI) has no counterpart here yet.

It imports nothing from the rest of the package and nothing beyond the
standard library, so every layer creates its locks through
:func:`~.lockorder.new_lock` without import cycles.  The sanitizer state
is this package's own: enabling the JAX package's sanitizer does not track
this package's locks, and the other way round.
"""

from __future__ import annotations

from . import lockorder  # noqa: F401  (re-exported submodule)
from .lockorder import new_lock  # noqa: F401

__all__ = ["lockorder", "new_lock"]
