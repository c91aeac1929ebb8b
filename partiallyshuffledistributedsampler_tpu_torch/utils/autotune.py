"""Cost-based backend selection for the single-source sampler's
``backend='auto'``.

The right backend for a rank depends on its shard size and on constants
only the running machine knows, so 'auto' measures them once per process
and compares the predicted per-epoch costs:

    est_host(ns)   = host_fixed + host_rate * ns
    est_device(ns) = dev_fixed  + dev_rate  * ns

Both lines are two-point fits over the real routes.  The host line runs
the windowed regen on the backend the host path would use (native C++ when
it loads, the CPU route otherwise); the device line runs what
``backend='cuda'`` pays per epoch: the kernel regen on the card and the
pinned readback of its indices.  With no usable card there is nothing to
price: 'auto' is the host backend, and no device probe runs.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import torch

#: process-wide memoized model: {host_backend, host_fixed_ms, host_rate_ms,
#: dev_fixed_ms, dev_rate_ms} (rates are ms per sample)
_MODEL: Optional[dict] = None

#: the shard sizes of the two-point fits, shared by both probes
_PROBE_SIZES = (65_536, 1_048_576)
#: probe window: the production default, capped at the probe size
_PROBE_WINDOW = 4096
_REPS = 3


def _best(fn, reps: int = _REPS) -> float:
    """Min wall-ms over reps (the min: probes fight host jitter)."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def _line(sizes, costs) -> Tuple[float, float]:
    """(fixed_ms, rate_ms_per_sample) from a two-point fit; noise can
    invert the points, so both terms are floored at zero."""
    rate = max((costs[1] - costs[0]) / (sizes[1] - sizes[0]), 0.0)
    fixed = max(costs[0] - rate * sizes[0], 0.0)
    return fixed, rate


def _probe(backend: str) -> Tuple[float, float]:
    """(fixed ms, ms per sample) of ``epoch_indices_host(backend, ...)`` at
    both probe sizes, each warmed first (allocations, page-in, the card's
    first launch); on 'cuda' the call includes the readback to the
    host."""
    from ..ops import epoch_indices_host

    costs = []
    for m in _PROBE_SIZES:
        w = min(_PROBE_WINDOW, m)
        epoch_indices_host(backend, m, w, 1, 0, 0, 1)
        epochs = iter(range(1, 1 + _REPS))
        costs.append(_best(lambda m=m, w=w: epoch_indices_host(
            backend, m, w, 1, next(epochs), 0, 1)))
    return _line(_PROBE_SIZES, costs)


def cost_model(force: bool = False) -> Optional[dict]:
    """The measured constants, memoized per process; None when no CUDA
    card is usable (the host path is then the only choice)."""
    global _MODEL
    if _MODEL is not None and not force:
        return _MODEL
    if not torch.cuda.is_available():
        return None
    from ..ops import resolve_host_backend

    host_backend = resolve_host_backend()
    host_fixed, host_rate = _probe(host_backend)
    dev_fixed, dev_rate = _probe("cuda")
    _MODEL = {
        "host_backend": host_backend,
        "host_fixed_ms": host_fixed,
        "host_rate_ms": host_rate,
        "dev_fixed_ms": dev_fixed,
        "dev_rate_ms": dev_rate,
    }
    return _MODEL


def pick_backend(num_samples: int) -> Tuple[str, Optional[dict]]:
    """Resolve 'auto' for a rank generating ``num_samples`` indices an
    epoch.  Returns ``(backend, info)``; ``info`` carries the model and
    both estimates (the sampler keeps it as ``_auto_cost``), or None when
    no card is usable."""
    model = cost_model()
    if model is None:
        from ..ops import resolve_host_backend

        return resolve_host_backend(), None
    est_host = model["host_fixed_ms"] + model["host_rate_ms"] * num_samples
    est_dev = model["dev_fixed_ms"] + model["dev_rate_ms"] * num_samples
    backend = "cuda" if est_dev < est_host else model["host_backend"]
    info = dict(model, est_host_ms=est_host, est_device_ms=est_dev,
                num_samples=num_samples, picked=backend)
    return backend, info
