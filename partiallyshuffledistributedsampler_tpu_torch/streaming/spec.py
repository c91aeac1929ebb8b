"""`StreamSpec`: the moving-horizon stream as a `PartialShuffleSpec`.

The stream is an unbounded append-only index space cut into consecutive
**horizons** of ``horizon`` samples.  Horizon generation ``g`` *is* the
epoch number everywhere else in the framework: horizon ``g``'s stream is
the ordinary windowed permutation of ``n = horizon`` samples at epoch
``g`` (the epoch already perturbs the permutation seed in every kernel),
offset by ``g * horizon`` into the absolute index space, so every
surface of a frozen epoch (elastic cascade layers included) applies to
an unbounded stream unchanged (docs/STREAMING.md).  The JAX package's
``StreamSpec``: the same config gives the same wire form, fingerprint and
streams.

Laws:

* **eligibility** — horizon ``g`` is servable once
  ``appended >= (g + 1) * horizon``: whole horizons only, so the
  permutation's input is always the full ``[g*H, (g+1)*H)`` block and
  the stream is a pure function of ``(spec, g, rank)``;
* **union** — for a plain-base stream the union over ranks of horizon
  ``g``'s indices is exactly ``[g*H, (g+1)*H)``, each index once
  (``drop_last`` trims the tail exactly as in a frozen epoch);
* **weights** — a mixture-base stream re-weights *per horizon*: the
  effective weights for horizon ``g`` are the base weights plus every
  additive delta folded in at advances ``<= g``.  Weights are **not**
  part of the wire form — the stream identity (fingerprint) is stable
  under re-weighting, exactly like ``world`` under elastic reshard.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..ops.mixture import MixtureSpec
from ..service.spec import PartialShuffleSpec

#: horizons of per-horizon weight entries kept when pruning at an
#: advance — mirrors the WAL's two-checkpoint retention with slack, so
#: every horizon above the truncation watermark regens bit-identically
WEIGHTS_RETAIN = 8


class StreamSpec(PartialShuffleSpec):
    """Immutable-by-convention description of one moving-horizon stream.

    ``horizon`` is the sliding-shuffle extent H (samples per horizon).
    The base shuffle is either the plain windowed permutation
    (``window=...``) or the §8 weighted mixture (``mixture=...`` — a
    ``MixtureSpec`` or its key tuple; each horizon is one mixture epoch
    of ``epoch_samples = horizon``).  Per-horizon effective weights are
    carried *outside* the wire form (:meth:`with_stream_weights`): two
    specs differing only in adopted weights are the same stream
    identity.
    """

    def __init__(
        self,
        *,
        horizon: int,
        window: Optional[int] = None,
        mixture=None,
        mixture_key=None,
        seed: int = 0,
        world: int = 1,
        backend: str = "cuda",
        **kwargs,
    ) -> None:
        horizon = int(horizon)
        if horizon < 1:
            raise ValueError(f"horizon must be >= 1, got {horizon}")
        if mixture is not None:
            if mixture_key is not None:
                raise ValueError("pass mixture or mixture_key, not both")
            mixture_key = (
                mixture.key() if isinstance(mixture, MixtureSpec)
                else tuple(mixture)
            )
        if mixture_key is not None:
            if window is not None:
                raise ValueError(
                    "window is carried by the mixture key (per-source "
                    "windows); omit it for mixture-base streams"
                )
            super().__init__(
                "mixture", mixture_key=mixture_key, epoch_samples=horizon,
                seed=seed, world=world, backend=backend, **kwargs,
            )
        else:
            if window is None:
                raise ValueError("plain-base streams need window")
            super().__init__(
                "plain", n=horizon, window=window, seed=seed, world=world,
                backend=backend, **kwargs,
            )
        #: the frozen-epoch machinery this stream rides ("plain"/"mixture")
        self.base_mode = self.mode
        self.mode = "stream"
        self.horizon = horizon
        # adopted per-horizon weights {g: (w0, w1, ...)} — deliberately
        # NOT part of the wire form / fingerprint (see class docstring)
        self._stream_weights: dict = {}

    # ----------------------------------------------------------- builders
    @classmethod
    def plain_stream(cls, horizon: int, *, window: int, seed: int = 0,
                     world: int = 1, backend: str = "cuda",
                     **kwargs) -> "StreamSpec":
        """A plain-base stream: each horizon is one §3/§4 epoch of H."""
        return cls(horizon=horizon, window=window, seed=seed, world=world,
                   backend=backend, **kwargs)

    @classmethod
    def mixture_stream(cls, horizon: int, *, mixture, seed: int = 0,
                       world: int = 1, backend: str = "cuda",
                       **kwargs) -> "StreamSpec":
        """A mixture-base stream: each horizon is one §8 mixture epoch of
        ``epoch_samples = horizon``, re-weightable per horizon."""
        return cls(horizon=horizon, mixture=mixture, seed=seed, world=world,
                   backend=backend, **kwargs)

    # ------------------------------------------------------------ horizons
    def eligible_horizons(self, appended: int) -> int:
        """Number of fully-appended (servable) horizons: ``g`` is
        eligible iff ``g < eligible_horizons(appended)``."""
        return int(appended) // self.horizon

    @property
    def stream_weights(self) -> dict:
        """The adopted per-horizon weights map (read-only view)."""
        return dict(self._stream_weights)

    def weights_for(self, g: int):
        """Effective mixture weights at horizon ``g``: the newest adopted
        entry at or below ``g``, else the base weights; ``None`` for a
        plain-base stream (nothing to weight)."""
        if self.base_mode != "mixture":
            return None
        g = int(g)
        best = None
        for k in self._stream_weights:
            if k <= g and (best is None or k > best):
                best = k
        if best is None:
            return tuple(int(x) for x in self.mixture_key[1])
        return self._stream_weights[best]

    def with_stream_weights(self, weights,
                            prune_below: Optional[int] = None) -> "StreamSpec":
        """The same stream identity with per-horizon weights adopted
        (merged over any existing entries).  ``weights`` maps horizon
        generation → per-source weight sequence; ``prune_below`` drops
        entries for horizons below the watermark (bounded state —
        docs/STREAMING.md), keeping at least the newest pruned entry's
        effect via :meth:`weights_for`'s newest-at-or-below rule."""
        out = self.from_wire(self.to_wire(), backend=self.backend)
        merged = dict(self._stream_weights)
        for g, w in (weights or {}).items():
            # mixture weights are integer quotas (ops/mixture.py) — keep
            # the adopted entries in the same vocabulary
            merged[int(g)] = tuple(int(x) for x in w)
        if prune_below is not None and merged:
            floor = int(prune_below)
            # keep the newest entry below the floor: it still anchors
            # weights_for() for every retained horizon above it
            anchor = max((g for g in merged if g < floor), default=None)
            merged = {g: w for g, w in merged.items()
                      if g >= floor or g == anchor}
        out._stream_weights = merged
        return out

    # ------------------------------------------------------------- streams
    def _base_for(self, g: int) -> PartialShuffleSpec:
        """The frozen per-horizon base spec horizon ``g`` evaluates as —
        a plain spec over ``n = horizon``, or a mixture spec with the
        horizon's effective weights substituted into the key."""
        if self.base_mode == "mixture":
            key = self.mixture_key
            w = self.weights_for(g)
            if w is not None:
                key = (tuple(key[0]), tuple(int(x) for x in w),
                       tuple(key[2]), key[3], key[4])
            return PartialShuffleSpec(
                "mixture", mixture_key=key, epoch_samples=self.horizon,
                seed=self.seed, world=self.world, backend=self.backend,
                **self.kwargs,
            )
        return PartialShuffleSpec(
            "plain", n=self.horizon, window=self.window, seed=self.seed,
            world=self.world, backend=self.backend, **self.kwargs,
        )

    def num_samples(self, rank: int = 0) -> Optional[int]:
        """Per-rank horizon length — constant across horizons (weights
        never move the partition sizes), which is what lets the advance
        barrier's completion test reuse the frozen drain math."""
        return self._base_for(0).num_samples(rank)

    def rank_indices(self, epoch: int, rank: int, *,
                     layers=None) -> np.ndarray:
        """Horizon ``epoch``'s stream for ``rank`` as *absolute*
        append-only indices (plain base: the within-horizon permutation
        offset by ``epoch * horizon``; mixture base: global ids into the
        frozen source space, re-weighted per horizon).  ``layers`` names
        a §6 elastic cascade exactly as for a frozen epoch — the barrier
        consumed-counts are within-horizon positions."""
        g = int(epoch)
        base = self._base_for(g)
        out = np.asarray(base.rank_indices(g, rank, layers=layers))
        if self.base_mode == "plain":
            out = out + np.int64(g) * np.int64(self.horizon)
        return out

    # ----------------------------------------------------------------- wire
    def to_wire(self) -> dict:
        d = {
            "mode": "stream",
            "seed": self.seed,
            "world": self.world,
            "kwargs": {k: self.kwargs[k] for k in sorted(self.kwargs)},
            "horizon": self.horizon,
        }
        if self.base_mode == "mixture":
            k = self.mixture_key
            d["mixture_key"] = [list(k[0]), list(k[1]), list(k[2]),
                                k[3], k[4]]
        else:
            d["window"] = self.window
        return d

    @classmethod
    def from_wire(cls, d: dict, *, backend: str = "cuda") -> "StreamSpec":
        d = dict(d)
        d.pop("mode", None)
        kwargs = d.pop("kwargs", {})
        mk = d.pop("mixture_key", None)
        if mk is not None:
            d["mixture_key"] = (tuple(mk[0]), tuple(mk[1]), tuple(mk[2]),
                                mk[3], mk[4])
        return cls(backend=backend, **d, **kwargs)

    def with_world(self, world: int) -> "StreamSpec":
        out = super().with_world(world)
        if out is not self:
            out._stream_weights = dict(self._stream_weights)
        return out
