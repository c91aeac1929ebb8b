"""Seeded latency models calibrated on the card.

A copy of the JAX package's ``fleetsim/latency.py`` with three
differences, all of them about where the numbers come from:

* ``RegenCostModel`` names its device line ``"cuda"`` (the JAX package
  says ``"xla"``): the answer ``utils/autotune.pick_backend`` gives.
* The defaults of :class:`Calibration` and :class:`RegenCostModel` are
  the card's own, measured by ``chip_smoke.py --sharding`` (phase 21) on
  the card named beside them (``CALIBRATED_ON``): the median of three
  runs' records, as ``from_bench`` takes it over them.
* :meth:`Calibration.from_bench` reads only records that phase 21 wrote
  on a card (``fleetsim_calibration*.json``, form below), never a run
  of another device; :meth:`RegenCostModel.from_bench` reads the same.

Phase 21 is a one-process harness: shards, routers and clients are
threads of one interpreter, so every channel carries that host's
contention (one GIL).  ``rpc`` is a cache-hit round trip through the
router with 8 clients done; ``regen`` a shard's ``epoch_regen_ms`` over
the deployment's 8 steady-state regens (two ranks a shard at once);
``wal_fsync`` the shards' group-commit; ``barrier`` the reshard's freeze
plus drain on each shard with all 256 ranks as client threads — the
last is the harness's as much as the plane's.

Two surfaces (docs/SIMULATOR.md):

* :class:`LatencyModel` — per-channel lognormal samplers for the four
  delays the serving plane actually pays: ``rpc`` (request dispatch +
  service), ``regen`` (per-epoch index regeneration), ``wal_fsync``
  (durability group-commit), ``barrier`` (reshard freeze + drain).
  Sampling is ``random.Random``-seeded per ``(seed, channel)``, so a
  channel's stream is independent of how often the others are drawn —
  adding a WAL sample never perturbs the rpc timeline.
* :class:`RegenCostModel` — the per-backend regen cost lines in exactly
  the shape ``utils/autotune.cost_model()`` measures (``host_fixed_ms +
  host_rate_ms*n`` vs ``dev_fixed_ms + dev_rate_ms*n``), so the
  simulator proves the autopilot's ``backend_pick`` arm against the
  same decision function the live controller uses, without paying the
  seconds-long card probe.

The calibration record (one JSON object a file, written by phase 21)::

    {"kind": "fleetsim_calibration", "source": "chip_smoke.py --sharding",
     "device": {"platform": "gpu", "name": "...", "power_limit": "..."},
     "channels": {"rpc": [p50_ms, sigma], "regen": [...],
                  "wal_fsync": [...], "barrier": [...]},
     "regen_cost": {"host_backend": ..., "host_fixed_ms": ..., ...}}

Each channel's ``(p50, sigma)`` is read off the phase's own samples:
``p50`` their median, ``sigma = ln(p99 / p50) / 2.326``.
"""

from __future__ import annotations

import json
import math
import random
from dataclasses import dataclass, fields, replace
from pathlib import Path
from typing import Optional

#: the delay families the simulator models, in documentation order
CHANNELS = ("rpc", "regen", "wal_fsync", "barrier")

#: the card the defaults below were measured on, as ``nvidia-smi
#: --query-gpu=name,power.limit --format=csv,noheader`` gives it
CALIBRATED_ON = "NVIDIA H100 80GB HBM3, 700.00 W"

#: the ``kind`` of a calibration record (module doc)
RECORD_KIND = "fleetsim_calibration"


@dataclass(frozen=True)
class Calibration:
    """Per-channel ``(p50_ms, sigma)`` of a lognormal delay model, by
    default the card's (``CALIBRATED_ON``): ``from_bench`` over the
    records of three ``chip_smoke.py --sharding`` runs, rounded to 4
    significant digits (module doc: a one-process harness)."""

    #: the ``GET_BATCH`` round trip through the router (lookahead 1, a
    #: cache hit, 4,096 int32), 954 samples a run
    rpc: tuple = (0.4574, 0.5902)
    #: a shard's ``epoch_regen_ms`` over C4 1B/8192 at world 256 (one
    #: kernel launch and the readback of 3.9M indices, host wall), the 8
    #: regens of 8 clients at once, two a shard
    regen: tuple = (23.87, 0.1315)
    #: the WAL group-commit (``wal_fsync_ms``), the median of 4 shards
    wal_fsync: tuple = (3.311, 0.6847)
    #: the cross-shard reshard's freeze plus drain on each of 4 shards
    #: (``barrier_freeze_ms`` + ``barrier_drain_ms``), 256 client threads
    barrier: tuple = (1811.0, 0.2543)

    @classmethod
    def from_bench(cls, root) -> "Calibration":
        """Recalibration from the records a card wrote under ``root``
        (``fleetsim_calibration*.json``, in file-name order; a file of
        another form or device is skipped): each channel takes the
        median of the records' p50s and that record's sigma.  Channels
        no record carries keep the defaults; so does a root with no
        record."""
        out = cls()
        recs = [rec for rec in _card_records(root)
                if isinstance(rec.get("channels"), dict)]
        for chan in CHANNELS:
            vals = []
            for rec in recs:
                v = rec["channels"].get(chan)
                if (isinstance(v, (list, tuple)) and len(v) == 2
                        and float(v[0]) > 0.0):
                    vals.append((float(v[0]), float(v[1])))
            if vals:
                vals.sort()
                out = replace(out, **{chan: vals[len(vals) // 2]})
        return out


def _card_records(root) -> list:
    """The calibration records a card wrote under ``root``, in file-name
    order; a file of another form or device is skipped."""
    recs = []
    for p in sorted(Path(root).glob("fleetsim_calibration*.json")):
        try:
            rec = json.loads(p.read_text())
        except (OSError, ValueError):
            continue
        if (isinstance(rec, dict) and rec.get("kind") == RECORD_KIND
                and isinstance(rec.get("device"), dict)
                and rec["device"].get("platform") == "gpu"):
            recs.append(rec)
    return recs


class LatencyModel:
    """Seeded per-channel lognormal delay sampler.

        lat = LatencyModel(seed=7)
        lat.sample("rpc")       # ms, deterministic stream per channel
        lat.p99("regen")        # closed-form lognormal p99

    A lognormal keeps every sample positive and gives the long right
    tail real service latencies show; ``p50`` anchors the median and
    ``sigma`` the spread (p99 ≈ p50·e^{2.326σ}).
    """

    def __init__(self, seed: int = 0,
                 calibration: Optional[Calibration] = None) -> None:
        self.seed = int(seed)
        self.calibration = calibration if calibration is not None \
            else Calibration()
        self._rngs = {c: random.Random(f"fleetsim:{self.seed}:{c}")
                      for c in CHANNELS}

    def params(self, channel: str) -> tuple:
        try:
            return getattr(self.calibration, channel)
        except AttributeError:
            raise KeyError(
                f"unknown latency channel {channel!r}; channels are "
                f"{list(CHANNELS)}") from None

    def sample(self, channel: str) -> float:
        """One delay in ms from ``channel``'s seeded stream."""
        p50, sigma = self.params(channel)
        g = self._rngs[channel].gauss(0.0, 1.0)
        return float(p50) * math.exp(float(sigma) * g)

    def p50(self, channel: str) -> float:
        return float(self.params(channel)[0])

    def p99(self, channel: str) -> float:
        """Closed-form lognormal p99 (z_{0.99} = 2.326)."""
        p50, sigma = self.params(channel)
        return float(p50) * math.exp(2.326 * float(sigma))


@dataclass(frozen=True)
class RegenCostModel:
    """Per-backend regen cost lines, shaped like ``autotune.cost_model()``.

    The defaults are the card's lines as ``autotune.cost_model()``
    measured them (``CALIBRATED_ON``, ``chip_smoke.py --sharding``; each
    field the median of three runs, as ``from_bench`` takes it): the
    host backend wins small per-rank epochs, the device line's flat
    launch-and-readback cost amortizes out on large ones.  ``pick``
    reproduces the exact comparison ``utils/autotune.pick_backend``
    performs, plus the gain margin the predictive policy's backend arm
    thresholds on.
    """

    host_backend: str = "native"
    host_fixed_ms: float = 0.8166
    host_rate_ms: float = 4.500e-5
    dev_fixed_ms: float = 0.1122      # launch + readback floor
    dev_rate_ms: float = 9.356e-8
    #: per-sampling-mode multipliers on the per-sample rate lines
    #: (docs/SAMPLING.md): a W1 regen (``weighted_stream``) over a C4
    #: regen (``index_amortized``) on the card, both at world 256;
    #: ``prioritized`` is the same kernel with a different table.  The
    #: dedup fold is a HOST-side sequential walk (seen-set bookkeeping on
    #: top of the base draws), so its host rate dominates and the device
    #: line gains nothing — without this term ``backend_pick`` would
    #: misprice dedup regen as device-cheap by orders of magnitude.
    weighted_rate_mult: float = 1.120
    #: a fresh 20,000-draw dedup regen on the host, per draw
    dedup_host_rate_ms: float = 5.515e-3

    @classmethod
    def from_bench(cls, root) -> "RegenCostModel":
        """The cost lines from the records a card wrote under ``root``
        (those :meth:`Calibration.from_bench` reads): each field takes
        the median of the records' values.  Fields no record carries
        keep the defaults; so does a root with no record."""
        out = cls()
        costs = [rec["regen_cost"] for rec in _card_records(root)
                 if isinstance(rec.get("regen_cost"), dict)]
        for f in fields(cls):
            kind = str if f.name == "host_backend" else (int, float)
            vals = sorted(c[f.name] for c in costs
                          if isinstance(c.get(f.name), kind))
            if vals:
                out = replace(out, **{f.name: vals[len(vals) // 2]})
        return out

    def estimate_ms(self, backend: str, num_samples: int,
                    sampling_mode: Optional[str] = None) -> float:
        n = max(0, int(num_samples))
        mult = (self.weighted_rate_mult
                if sampling_mode in ("weighted", "prioritized") else 1.0)
        if sampling_mode == "dedup":
            # the fold is host-resident regardless of backend: the
            # device accelerates only the base draws
            return (self.host_fixed_ms + self.host_rate_ms * n
                    + self.dedup_host_rate_ms * n)
        if backend == "cuda":
            return self.dev_fixed_ms + self.dev_rate_ms * mult * n
        return self.host_fixed_ms + self.host_rate_ms * mult * n

    def pick(self, num_samples: int,
             sampling_mode: Optional[str] = None) -> tuple:
        """``(backend, gain_pct, info)`` for a per-rank epoch of
        ``num_samples`` indices; ``info`` matches the live probe's
        shape (est_host_ms / est_device_ms / picked).
        ``sampling_mode`` prices the non-uniform kernels: dedup regen
        pins to the host line (the fold is sequential there), so the
        device arm can never look spuriously attractive for it."""
        est_host = self.estimate_ms(self.host_backend, num_samples,
                                    sampling_mode)
        est_dev = self.estimate_ms("cuda", num_samples, sampling_mode)
        backend = "cuda" if est_dev < est_host else self.host_backend
        worse, best = max(est_host, est_dev), min(est_host, est_dev)
        gain_pct = 0.0 if worse <= 0.0 else 100.0 * (worse - best) / worse
        info = {
            "host_backend": self.host_backend,
            "host_fixed_ms": self.host_fixed_ms,
            "host_rate_ms": self.host_rate_ms,
            "dev_fixed_ms": self.dev_fixed_ms,
            "dev_rate_ms": self.dev_rate_ms,
            "est_host_ms": est_host,
            "est_device_ms": est_dev,
            "num_samples": int(num_samples),
            "picked": backend,
        }
        if sampling_mode is not None:
            info["sampling_mode"] = str(sampling_mode)
        return backend, float(gain_pct), info
