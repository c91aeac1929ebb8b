"""`SamplingSpec`: weighted / prioritized / dedup streams as specs.

Three non-uniform sampling modes ride the ordinary
:class:`~..service.spec.PartialShuffleSpec` surface, with the JAX
package's wire form and fingerprint (its ``sampling/spec.py``):

* ``weighted``: importance-weighted draws; an exact-integer alias table
  (``sampling/alias.py``) picks the source per draw ordinal, a hashed
  within-source draw places the sample, and the within-window offset rides
  the shared ``swap_or_not`` bijection;
* ``prioritized``: the weighted stream with per-epoch weights adopted
  through :meth:`SamplingSpec.with_stream_weights`, outside the wire form
  and fingerprint, like a re-weighted stream horizon;
* ``dedup``: the weighted stream filtered through a deterministic seeded
  seen-set (``sampling/dedup.py``), so repeats are suppressed across
  epochs; the epoch-boundary seen state is a pure function of ``(spec,
  epoch)``, and :meth:`SamplingSpec.with_dedup_boundary` injects a
  snapshot of it.

On 'cuda' (the default) a weighted or prioritized ``rank_indices`` is one
``weighted_stream(_wide)`` launch and one readback; a dedup epoch's
candidates are ``retries + 1`` launches and one readback, and its fold is
host Python.  On 'cpu' the same streams come from the plain law.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np

from .. import faults as F
from .. import telemetry
from ..analysis.lockorder import new_lock
from ..ops import core, host_array
from ..service.spec import PartialShuffleSpec
# per-epoch adopted-weights retention shares the stream horizon's bound
from ..streaming.spec import WEIGHTS_RETAIN
from . import alias as A
from .dedup import fold_epoch, make_seen, restore_seen

__all__ = ["SAMPLING_MODES", "SamplingSpec", "WEIGHTS_RETAIN"]

#: the three non-uniform sampling modes, in documentation order
SAMPLING_MODES = ("weighted", "prioritized", "dedup")

#: dedup epoch streams kept memoized per spec (boundary states are cheap
#: and kept for every folded epoch; streams are O(T) arrays)
_STREAM_CACHE_KEEP = 4


def _normalize_dedup(cfg: Optional[dict]) -> dict:
    cfg = dict(cfg or {})
    kind = cfg.pop("kind", "exact")
    out = {"kind": kind, "retries": int(cfg.pop("retries", 4))}
    if out["retries"] < 0:
        raise ValueError(f"dedup retries must be >= 0, got {out['retries']}")
    if kind == "bloom":
        out["bits"] = int(cfg.pop("bits", 1 << 20))
        out["hashes"] = int(cfg.pop("hashes", 4))
    elif kind != "exact":
        raise ValueError(
            f"dedup kind must be 'exact' or 'bloom', got {kind!r}")
    if cfg:
        raise ValueError(f"unknown dedup config keys: {sorted(cfg)}")
    return out


class SamplingSpec(PartialShuffleSpec):
    """Immutable-by-convention description of one non-uniform stream.

    ``source_sizes`` partitions the global id space ``[0, sum(sizes))``
    into consecutive per-source blocks; ``weights`` are non-negative
    integer quotas (``weight_kind='per_source'`` weighs whole sources,
    ``'per_sample'`` their samples); ``epoch_samples`` is the epoch draw
    count T.  Adopted per-epoch weights (prioritized) and dedup seen-state
    snapshots live outside the wire form: two specs differing only in them
    are the same stream identity."""

    def __init__(
        self,
        sampling_mode: str,
        *,
        source_sizes,
        epoch_samples: int,
        weights=None,
        weight_kind: str = "per_source",
        window: Optional[int] = None,
        dedup: Optional[dict] = None,
        seed: int = 0,
        world: int = 1,
        backend: str = "cuda",
        **kwargs,
    ) -> None:
        if sampling_mode not in SAMPLING_MODES:
            raise ValueError(
                f"sampling mode must be one of {SAMPLING_MODES}, "
                f"got {sampling_mode!r}")
        sizes = tuple(int(n) for n in source_sizes)
        window = core.DEFAULT_WINDOW if window is None else int(window)
        # the plain carrier resolves backend/world/kwargs; mode is then
        # rebound to the sampling mode (the StreamSpec pattern)
        super().__init__(
            "plain", n=sum(sizes), window=window, seed=seed, world=world,
            backend=backend, **kwargs,
        )
        self.sampling_mode = sampling_mode
        self.mode = sampling_mode
        self.source_sizes = sizes
        self.weights = (tuple(int(x) for x in weights)
                        if weights is not None else (1,) * len(sizes))
        self.weight_kind = str(weight_kind)
        self.epoch_samples = int(epoch_samples)
        if self.epoch_samples < 1:
            raise ValueError(
                f"epoch_samples must be >= 1, got {self.epoch_samples}")
        if sampling_mode == "dedup":
            self.dedup = _normalize_dedup(dedup)
        else:
            if dedup is not None:
                raise ValueError(
                    f"dedup config is only valid for mode='dedup', "
                    f"not {sampling_mode!r}")
            self.dedup = None
        # a malformed static config fails here, not at first serve
        A.build_alias_table(self.weights, self.weight_kind, sizes)
        # adopted per-epoch weights {epoch: (w0, ...)}: prioritized mode
        # only, deliberately NOT part of the wire form/fingerprint
        self._sampling_weights: dict = {}
        # dedup memoization, all guarded by self._dedup_lock:
        #   _dedup_boundary: epoch -> seen-set at that epoch's START
        #   _dedup_streams:  epoch -> folded global stream (length T)
        self._dedup_lock = new_lock("sampling.spec")
        self._dedup_boundary: dict = {}
        self._dedup_streams: dict = {}

    # ------------------------------------------------------- constructors
    @classmethod
    def weighted(cls, source_sizes, weights, *, epoch_samples: int,
                 weight_kind: str = "per_source", seed: int = 0,
                 world: int = 1, backend: str = "cuda",
                 **kwargs) -> "SamplingSpec":
        """The static importance-weighted stream."""
        return cls("weighted", source_sizes=source_sizes, weights=weights,
                   weight_kind=weight_kind, epoch_samples=epoch_samples,
                   seed=seed, world=world, backend=backend, **kwargs)

    @classmethod
    def prioritized(cls, source_sizes, weights, *, epoch_samples: int,
                    weight_kind: str = "per_source", seed: int = 0,
                    world: int = 1, backend: str = "cuda",
                    **kwargs) -> "SamplingSpec":
        """The weighted stream with per-epoch re-weighting."""
        return cls("prioritized", source_sizes=source_sizes,
                   weights=weights, weight_kind=weight_kind,
                   epoch_samples=epoch_samples, seed=seed, world=world,
                   backend=backend, **kwargs)

    @classmethod
    def deduped(cls, source_sizes, *, epoch_samples: int, weights=None,
                weight_kind: str = "per_source", dedup=None, seed: int = 0,
                world: int = 1, backend: str = "cuda",
                **kwargs) -> "SamplingSpec":
        """The seen-set filtered stream (uniform weights by default)."""
        return cls("dedup", source_sizes=source_sizes, weights=weights,
                   weight_kind=weight_kind, epoch_samples=epoch_samples,
                   dedup=dedup or {}, seed=seed, world=world,
                   backend=backend, **kwargs)

    # ----------------------------------------------------- dynamic weights
    @property
    def stream_weights(self) -> dict:
        """The adopted per-epoch weights map (read-only view), the same
        accessor the stream horizon exposes."""
        return dict(self._sampling_weights)

    def weights_for(self, g: int):
        """Adopted effective weights at epoch ``g``: the newest adopted
        entry at or below ``g``, else ``None`` (static so far)."""
        if self.sampling_mode != "prioritized":
            return None
        g = int(g)
        best = None
        for k in self._sampling_weights:
            if k <= g and (best is None or k > best):
                best = k
        return None if best is None else self._sampling_weights[best]

    def effective_weights(self, g: int) -> tuple:
        """The weights epoch ``g``'s alias table is built from: the newest
        adopted entry at or below ``g``, else the base weights."""
        w = self.weights_for(g)
        return self.weights if w is None else tuple(int(x) for x in w)

    def with_stream_weights(self, weights,
                            prune_below: Optional[int] = None
                            ) -> "SamplingSpec":
        """The same stream identity with per-epoch weights adopted (merged
        over existing entries), the stream horizon's adoption law:
        ``prune_below`` drops old entries but keeps the newest below the
        floor as the anchor for ``weights_for``."""
        if self.sampling_mode != "prioritized":
            raise ValueError(
                f"mode {self.sampling_mode!r} has static weights; only "
                f"'prioritized' adopts per-epoch weights")
        out = self.from_wire(self.to_wire(), backend=self.backend)
        merged = dict(self._sampling_weights)
        for g, w in (weights or {}).items():
            merged[int(g)] = tuple(int(x) for x in w)
        if prune_below is not None and merged:
            floor = int(prune_below)
            anchor = max((g for g in merged if g < floor), default=None)
            merged = {g: w for g, w in merged.items()
                      if g >= floor or g == anchor}
        out._sampling_weights = merged
        return out

    # --------------------------------------------------------- alias table
    def _table_for(self, epoch: int) -> A.AliasTable:
        """Epoch's alias table, built through the ``sampling.alias_build``
        fault site.  A build fault (adopted weights of the wrong length or
        zero mass, or an injected one) falls back to the UNIFORM table,
        loudly (telemetry event + RuntimeWarning): a degraded-but-serving
        stream beats a dead epoch, and the fallback is deterministic, so
        every surface that hits the same fault serves the same stream."""
        w = self.effective_weights(epoch)
        try:
            F.fire("sampling.alias_build")
            return A.build_alias_table(w, self.weight_kind,
                                       self.source_sizes)
        except F.InjectedThreadDeath:
            raise
        except Exception as exc:  # lint: allow-broad-except(alias-build fault degrades to the uniform table, loudly)
            telemetry.event("sampling_alias_fallback", epoch=int(epoch),
                            detail=repr(exc))
            warnings.warn(
                f"alias table build failed for epoch {int(epoch)} "
                f"({exc!r}); serving UNIFORM weights", RuntimeWarning,
                stacklevel=2)
            return A.build_alias_table((1,) * len(self.source_sizes),
                                       "per_source", self.source_sizes)

    # -------------------------------------------------------------- sizing
    def num_samples(self, rank: int = 0) -> Optional[int]:
        """Per-rank epoch length: constant across epochs and weight
        adoptions (T never moves)."""
        return core.shard_sizes(
            self.epoch_samples, self.world,
            self.kwargs.get("drop_last", False))[0]

    # ------------------------------------------------------------- streams
    def _kernel_kwargs(self) -> dict:
        return dict(
            epoch_samples=self.epoch_samples, window=self.window,
            shuffle=self.kwargs.get("shuffle", True),
            drop_last=self.kwargs.get("drop_last", False),
            partition=self.kwargs.get("partition", "strided"),
            rounds=self.kwargs.get("rounds", core.DEFAULT_ROUNDS),
        )

    def _fold_kwargs(self) -> dict:
        return dict(window=self.window,
                    shuffle=self.kwargs.get("shuffle", True),
                    rounds=self.kwargs.get("rounds", core.DEFAULT_ROUNDS),
                    retries=self.dedup["retries"], backend=self.backend)

    def rank_indices(self, epoch: int, rank: int, *,
                     layers=None) -> np.ndarray:
        """The rank's epoch stream (or its remainder after the cascade
        ``layers``) as host sample ids.  On 'cuda' the kernel runs on the
        current device and stream, and the host waits for the one
        readback."""
        if not 0 <= rank < self.world:
            raise ValueError(f"rank must be in [0, {self.world}), got {rank}")
        epoch = int(epoch)
        layers = None if not layers else [(int(w), int(c)) for w, c in layers]
        if self.sampling_mode == "dedup":
            return self._dedup_rank_indices(epoch, rank, layers)
        table = self._table_for(epoch)
        kw = self._kernel_kwargs()
        args = (table, self.source_sizes, self.seed, epoch, rank, self.world)
        if self.backend == "cuda":
            if layers is not None:
                out = A.weighted_elastic_indices_cuda(*args, layers, **kw)
            else:
                out = A.weighted_epoch_indices_cuda(*args, **kw)
        elif layers is not None:
            out = A.weighted_elastic_indices_cpu(*args, layers, **kw)
        else:
            out = A.weighted_epoch_indices_cpu(*args, **kw)
        return host_array(out)

    # ---------------------------------------------------------- dedup fold
    def _boundary_for_locked(self, epoch: int):
        """Seen-set at ``epoch``'s start (a working copy): resumes from the
        newest cached/injected boundary at or below ``epoch`` and folds
        forward, caching every intermediate boundary.  Under
        ``self._dedup_lock``."""
        keys = [k for k in self._dedup_boundary if k <= epoch]
        if keys:
            k = max(keys)
            seen = self._dedup_boundary[k].copy()
        else:
            k, seen = 0, make_seen(self.dedup, self.seed)
        while k < epoch:
            fold_epoch(self._table_for(k), self.source_sizes, self.seed, k,
                       self.epoch_samples, seen, **self._fold_kwargs())
            k += 1
            self._dedup_boundary.setdefault(k, seen.copy())
        return seen

    def _dedup_stream(self, epoch: int) -> np.ndarray:
        """Epoch's global filtered stream (length T), memoized."""
        with self._dedup_lock:
            hit = self._dedup_streams.get(epoch)
            if hit is not None:
                return hit
            seen = self._boundary_for_locked(epoch)
            stream = fold_epoch(
                self._table_for(epoch), self.source_sizes, self.seed,
                epoch, self.epoch_samples, seen, **self._fold_kwargs())
            self._dedup_boundary.setdefault(epoch + 1, seen)
            self._dedup_streams[epoch] = stream
            for k in sorted(self._dedup_streams)[:-_STREAM_CACHE_KEEP]:
                del self._dedup_streams[k]
            return stream

    def _dedup_rank_indices(self, epoch: int, rank: int,
                            layers) -> np.ndarray:
        stream = self._dedup_stream(epoch)
        T = self.epoch_samples
        partition = self.kwargs.get("partition", "strided")
        wide = core.is_wide(T)
        if layers is None:
            p = core.rank_positions(T, rank, self.world,
                                    self.num_samples(rank), partition, wide)
        else:
            chain, remaining, ns = core.elastic_chain(
                T, layers, self.world, self.kwargs.get("drop_last", False))
            if remaining == 0 or ns == 0:
                return np.empty(0, dtype=stream.dtype)
            q = core.rank_positions(remaining, rank, self.world, ns,
                                    partition, wide)
            p = core.compose_remainder_chain(q, chain, partition, wide) % T
        return stream[p.numpy()]

    # ------------------------------------------------- dedup checkpointing
    def dedup_boundary_wire(self, epoch: int) -> Optional[dict]:
        """The newest cached epoch-boundary seen-state at or below
        ``epoch`` as a JSON-safe dict, or None when nothing is cached (or
        the mode has no seen-set)."""
        if self.sampling_mode != "dedup":
            return None
        with self._dedup_lock:
            keys = [k for k in self._dedup_boundary if k <= int(epoch)]
            if not keys:
                return None
            k = max(keys)
            return {"epoch": int(k),
                    "seen": self._dedup_boundary[k].snapshot()}

    def with_dedup_boundary(self, epoch: int, seen_wire: dict
                            ) -> "SamplingSpec":
        """The same spec with an epoch-start seen-state injected (from a
        snapshot): later folds resume from it instead of refolding epochs
        ``0..epoch-1``."""
        if self.sampling_mode != "dedup":
            raise ValueError("only mode='dedup' carries seen-state")
        out = self.from_wire(self.to_wire(), backend=self.backend)
        with self._dedup_lock:
            out._dedup_boundary = {
                k: v.copy() for k, v in self._dedup_boundary.items()}
        out._dedup_boundary[int(epoch)] = restore_seen(seen_wire,
                                                       self.seed)
        return out

    # ----------------------------------------------------------------- wire
    def to_wire(self) -> dict:
        d = {
            "mode": self.sampling_mode,
            "seed": self.seed,
            "world": self.world,
            "kwargs": {k: self.kwargs[k] for k in sorted(self.kwargs)},
            "source_sizes": [int(n) for n in self.source_sizes],
            "weights": [int(x) for x in self.weights],
            "weight_kind": self.weight_kind,
            "epoch_samples": int(self.epoch_samples),
            "window": int(self.window),
        }
        if self.dedup is not None:
            d["dedup"] = {k: self.dedup[k] for k in sorted(self.dedup)}
        return d

    @classmethod
    def from_wire(cls, d: dict, *, backend: str = "cuda") -> "SamplingSpec":
        d = dict(d)
        mode = d.pop("mode")
        kwargs = d.pop("kwargs", {})
        return cls(mode, backend=backend, **d, **kwargs)

    def with_world(self, world: int) -> "SamplingSpec":
        out = super().with_world(world)
        if out is not self:
            out._sampling_weights = dict(self._sampling_weights)
            with self._dedup_lock:
                # the fold is world-independent (it walks GLOBAL draw
                # ordinals), so boundary/stream caches carry across
                out._dedup_boundary = {
                    k: v.copy() for k, v in self._dedup_boundary.items()}
                out._dedup_streams = dict(self._dedup_streams)
        return out
