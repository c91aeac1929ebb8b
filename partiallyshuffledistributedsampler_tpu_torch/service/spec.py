"""`PartialShuffleSpec`: one serializable description of an index stream.

The dispatch ``HostDataLoader`` performs locally (plain §3/§4 stream, §8
mixture stream, §7 shard-expansion stream, each with an optional §6
elastic remainder) factored into one value object:

* ``rank_indices(epoch, rank)`` — the rank's full epoch stream as a host
  array, bit-identical to the JAX package's spec of the same config;
* ``to_wire()`` / ``from_wire()`` — a JSON-safe dict naming the stream,
  string-equal to the JAX package's wire form, so a client of this
  package and a server of the other can refuse a config mismatch instead
  of serving a silently different permutation;
* ``fingerprint()`` — a stable string of the wire form for cheap
  equality checks.

The backend ('cuda', the default, 'cpu', 'native', or 'auto', which
resolves to the host backend: 'native' when it loads, else 'cpu') is
checked at construction and is deliberately *excluded* from the wire form: every backend evaluates
the same normative stream.  On 'cuda' every route runs the hand-written
kernels and reads the rank's stream back once, into pinned memory
(``ops.host_array``):

==============================  =============================================
stream                          route
==============================  =============================================
plain                           ``epoch_indices_cuda`` (``index_amortized``
                                or ``index_general``)
mixture                         ``mixture_epoch_indices_cuda``
                                (``mixture_fused``)
mixture, elastic ``layers``     ``mixture_elastic_indices_cuda``
shard                           the shard ids by the index kernels, expanded
                                on the card by ``shard_row_keys`` +
                                ``shard_expand`` without leaving it
plain or shard, ``layers``      ``core.elastic_chain`` +
                                ``elastic_indices_cuda`` (``index_positions``)
==============================  =============================================

On 'cpu' the same streams come from the port's ``_cpu`` twins; on
'native' from the C++ host kernel (``ops/native.py``), the elastic
remainders of plain and shard streams from the CPU route.  The
weighted, prioritized and dedup wire modes are
``sampling.SamplingSpec``'s (``weighted_stream``); ``from_wire`` hands
them to it.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np

from ..ops import (
    core,
    ensure_index_backend,
    host_array,
    resolve_host_backend,
)
from ..ops.mixture import MixtureSpec

_MODES = ("plain", "mixture", "shard")
#: the sampler kwargs a stream threads through to the law
_LAW_KWARGS = ("shuffle", "drop_last", "order_windows", "partition",
               "rounds")
#: the non-uniform sampling wire modes (``sampling.SamplingSpec``)
_SAMPLING_MODES = ("weighted", "prioritized", "dedup")


class PartialShuffleSpec:
    """Immutable-by-convention description of one partial-shuffle stream."""

    def __init__(
        self,
        mode: str,
        *,
        seed: int = 0,
        world: int = 1,
        backend: str = "cuda",
        n: Optional[int] = None,
        window: Optional[int] = None,
        mixture_key=None,
        epoch_samples: Optional[int] = None,
        shard_sizes=None,
        within_shard_shuffle=True,
        **kwargs,
    ) -> None:
        if mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
        self.mode = mode
        self.seed, self.world = int(seed), int(world)
        if self.world < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        if "use_pallas" in kwargs:
            raise TypeError(
                "use_pallas is a speed knob of the JAX package's xla "
                "backend; this package has no Pallas path"
            )
        if backend == "auto":
            backend = resolve_host_backend()
        ensure_index_backend(backend)  # fail at construction, not epoch 1
        self.backend = backend
        self.kwargs = {k: kwargs.pop(k) for k in _LAW_KWARGS if k in kwargs}
        if kwargs:
            raise TypeError(f"unknown spec kwargs: {sorted(kwargs)}")
        self.n = None if n is None else int(n)
        self.window = None if window is None else int(window)
        self.mixture_key = mixture_key
        self.epoch_samples = (
            None if epoch_samples is None else int(epoch_samples)
        )
        self.shard_sizes = (
            None if shard_sizes is None
            else np.asarray(shard_sizes, dtype=np.int64)
        )
        self.within_shard_shuffle = (
            within_shard_shuffle if isinstance(within_shard_shuffle, bool)
            else int(within_shard_shuffle)
        )
        self._mixture_spec = None
        if mode == "plain":
            if self.n is None or self.window is None:
                raise ValueError("plain mode needs n and window")
        elif mode == "mixture":
            if mixture_key is None:
                raise ValueError("mixture mode needs mixture_key")
            self._mixture_spec = self._build_mixture()
        else:  # shard
            if self.shard_sizes is None:
                raise ValueError("shard mode needs shard_sizes")
            if self.window is None:
                self.window = 64  # the shard sampler's locality default

    # ----------------------------------------------------------- builders
    @classmethod
    def plain(cls, n: int, *, window: int, seed: int = 0, world: int = 1,
              backend: str = "cuda", **kwargs) -> "PartialShuffleSpec":
        """The single-source §3/§4 stream (what the sampler serves)."""
        return cls("plain", n=n, window=window, seed=seed, world=world,
                   backend=backend, **kwargs)

    @classmethod
    def mixture(cls, mixture, *, seed: int = 0, world: int = 1,
                epoch_samples: Optional[int] = None, backend: str = "cuda",
                **kwargs) -> "PartialShuffleSpec":
        """The §8 weighted-mixture stream; ``mixture`` is a ``MixtureSpec``
        or its :meth:`~..ops.mixture.MixtureSpec.key` tuple."""
        key = mixture.key() if isinstance(mixture, MixtureSpec) else mixture
        return cls("mixture", mixture_key=tuple(key), seed=seed, world=world,
                   epoch_samples=epoch_samples, backend=backend, **kwargs)

    @classmethod
    def shard(cls, shard_sizes, *, window: int = 64, seed: int = 0,
              world: int = 1, within_shard_shuffle=True,
              backend: str = "cuda", **kwargs) -> "PartialShuffleSpec":
        """The §7 shard-index stream, expanded to global sample indices."""
        return cls("shard", shard_sizes=shard_sizes, window=window, seed=seed,
                   world=world, within_shard_shuffle=within_shard_shuffle,
                   backend=backend, **kwargs)

    def _build_mixture(self) -> MixtureSpec:
        key = self.mixture_key
        # wire form arrives as nested lists; from_key wants tuples
        key = (tuple(key[0]), tuple(key[1]), tuple(key[2]), key[3], key[4])
        self.mixture_key = key
        return MixtureSpec.from_key(key)

    @property
    def mixture_spec(self) -> Optional[MixtureSpec]:
        return self._mixture_spec

    def _law(self) -> dict:
        """The law kwargs with their defaults filled in."""
        return dict(
            shuffle=self.kwargs.get("shuffle", True),
            drop_last=self.kwargs.get("drop_last", False),
            order_windows=self.kwargs.get("order_windows", True),
            partition=self.kwargs.get("partition", "strided"),
            rounds=self.kwargs.get("rounds", core.DEFAULT_ROUNDS),
        )

    # -------------------------------------------------------------- sizing
    def num_samples(self, rank: int = 0) -> Optional[int]:
        """Per-rank epoch length; ``None`` for shard mode (the expansion
        length follows the rank's shard draw — serve and count)."""
        if self.mode == "plain":
            return core.shard_sizes(
                self.n, self.world, self.kwargs.get("drop_last", False)
            )[0]
        if self.mode == "mixture":
            from ..ops.mixture import mixture_epoch_sizes

            _, ns, _ = mixture_epoch_sizes(
                self._mixture_spec, self.epoch_samples, self.world,
                self.kwargs.get("drop_last", False),
            )
            return ns
        return None

    # ------------------------------------------------------------- streams
    def rank_indices(self, epoch: int, rank: int, *,
                     layers=None) -> np.ndarray:
        """The rank's full epoch stream as host sample indices — the
        normative stream every consumer surface of this config serves.

        ``layers`` names a §6 elastic reshard cascade
        (``[(old_world, consumed), ...]`` outermost first, consumed counted
        in this spec's base units: samples for plain/mixture, SHARDS for
        shard mode); the stream is then the epoch's remainder after the
        cascade, partitioned at this spec's (new) ``world``.  On 'cuda' the
        kernels run on the current device and stream, and the host waits
        for the one readback."""
        if not 0 <= rank < self.world:
            raise ValueError(f"rank must be in [0, {self.world}), got {rank}")
        epoch = int(epoch)
        layers = None if not layers else [(int(w), int(c)) for w, c in layers]
        if self.mode == "mixture":
            return self._mixture_indices(epoch, rank, layers)
        ids = self._index_ids(epoch, rank, layers)
        if self.mode == "plain":
            return host_array(ids)
        return self._expand(ids, epoch)

    def _index_ids(self, epoch: int, rank: int, layers):
        """The §3/§4 stream (or its §6 remainder) over this spec's index
        space — samples, or shards — as a tensor: on the card for 'cuda',
        else on the host."""
        n = self.n if self.mode == "plain" else len(self.shard_sizes)
        law = self._law()
        if layers is None:
            if self.backend == "cuda":
                from ..ops.cuda import epoch_indices_cuda

                return epoch_indices_cuda(n, self.window, self.seed, epoch,
                                          rank, self.world, **law)
            if self.backend == "native":
                import torch

                from ..ops.native import epoch_indices_native

                return torch.from_numpy(epoch_indices_native(
                    n, self.window, self.seed, epoch, rank, self.world,
                    **law))
            from ..ops.cpu import epoch_indices_cpu

            return epoch_indices_cpu(n, self.window, self.seed, epoch, rank,
                                     self.world, **law)
        if self.backend != "cuda":
            from ..ops.cpu import elastic_indices_cpu

            return elastic_indices_cpu(n, self.window, self.seed, epoch,
                                       rank, self.world, layers, **law)
        import torch

        from ..ops.cuda import elastic_indices_cuda

        chain, remaining, num_samples = core.elastic_chain(
            n, layers, self.world, law.pop("drop_last"))
        if remaining == 0 or num_samples == 0:
            return torch.empty(0, dtype=core.out_dtype(n), device="cuda")
        return elastic_indices_cuda(n, self.window, self.seed, epoch, rank,
                                    self.world, num_samples, chain, **law)

    def _expand(self, ids, epoch: int) -> np.ndarray:
        """The shard ids expanded to global sample indices (int64, as the
        JAX package gives them): on the card the ids never leave it."""
        rounds = self.kwargs.get("rounds", core.DEFAULT_ROUNDS)
        if self.backend == "cpu":
            from ..sampler.shard_mode import expand_shard_indices_cpu

            return expand_shard_indices_cpu(
                ids.numpy(), self.shard_sizes, seed=self.seed, epoch=epoch,
                within_shard_shuffle=self.within_shard_shuffle,
                rounds=rounds).numpy()
        if self.backend == "native":
            from ..ops.native import expand_shard_indices_native

            return expand_shard_indices_native(
                ids.numpy(), self.shard_sizes, seed=self.seed, epoch=epoch,
                within_shard_shuffle=self.within_shard_shuffle,
                rounds=rounds)
        from ..ops.shard import shuffle_mode
        from ..sampler.shard_mode import _expand_confirmed

        full, w = shuffle_mode(self.within_shard_shuffle)
        # the ids come from the index kernels over len(shard_sizes) shards:
        # in range by construction, so the expansion reads nothing back
        out = _expand_confirmed(ids, self.shard_sizes, ids.device,
                                id_space=len(self.shard_sizes),
                                seed=self.seed, epoch=epoch, full=full, w=w,
                                rounds=rounds, plain=False)
        return host_array(out).astype(np.int64, copy=False)

    def rank_unit_sizes(self, epoch: int, rank: int, *, layers=None):
        """Per-base-unit sample counts of the rank's stream, or ``None``
        when units ARE samples (plain/mixture).  For shard mode this is
        ``shard_sizes[shard_draw]`` — what a consumption watermark in
        samples needs to be converted to whole consumed SHARDS."""
        if self.mode != "shard":
            return None
        layers = None if not layers else [(int(w), int(c)) for w, c in layers]
        ids = host_array(self._index_ids(int(epoch), rank, layers))
        return self.shard_sizes[ids]

    def _mixture_indices(self, epoch: int, rank: int,
                         layers=None) -> np.ndarray:
        from ..ops import mixture as M

        kw = dict(epoch_samples=self.epoch_samples, **self._law())
        spec = self._mixture_spec
        if self.backend == "cuda":
            if layers is not None:
                out = M.mixture_elastic_indices_cuda(
                    spec, self.seed, epoch, rank, self.world, layers, **kw)
            else:
                out = M.mixture_epoch_indices_cuda(
                    spec, self.seed, epoch, rank, self.world, **kw)
        elif self.backend == "native":
            from ..ops import native

            if layers is not None:
                return native.mixture_elastic_indices_native(
                    spec, self.seed, epoch, rank, self.world, layers, **kw)
            return native.mixture_epoch_indices_native(
                spec, self.seed, epoch, rank, self.world, **kw)
        elif layers is not None:
            out = M.mixture_elastic_indices_cpu(
                spec, self.seed, epoch, rank, self.world, layers, **kw)
        else:
            out = M.mixture_epoch_indices_cpu(
                spec, self.seed, epoch, rank, self.world, **kw)
        return host_array(out)

    # ----------------------------------------------------------------- wire
    def to_wire(self) -> dict:
        """JSON-safe dict naming the stream (NOT the backend — every
        backend serves the same normative stream)."""
        d = {
            "mode": self.mode,
            "seed": self.seed,
            "world": self.world,
            "kwargs": {k: self.kwargs[k] for k in sorted(self.kwargs)},
        }
        if self.mode == "plain":
            d["n"] = self.n
            d["window"] = self.window
        elif self.mode == "mixture":
            d["mixture_key"] = _wire_key(self.mixture_key)
            d["epoch_samples"] = self.epoch_samples
        else:
            d["shard_sizes"] = [int(s) for s in self.shard_sizes]
            d["window"] = self.window
            d["within_shard_shuffle"] = self.within_shard_shuffle
        return d

    @classmethod
    def from_wire(cls, d: dict, *,
                  backend: str = "cuda") -> "PartialShuffleSpec":
        if d.get("mode") == "stream" and cls is PartialShuffleSpec:
            # the moving-horizon stream rides the same wire surface; its
            # subclass owns the round-trip
            from ..streaming.spec import StreamSpec

            return StreamSpec.from_wire(d, backend=backend)
        if d.get("mode") in _SAMPLING_MODES and cls is PartialShuffleSpec:
            # the non-uniform sampling modes likewise
            from ..sampling.spec import SamplingSpec

            return SamplingSpec.from_wire(d, backend=backend)
        d = dict(d)
        kwargs = d.pop("kwargs", {})
        mk = d.pop("mixture_key", None)
        if mk is not None:
            d["mixture_key"] = (tuple(mk[0]), tuple(mk[1]), tuple(mk[2]),
                                mk[3], mk[4])
        return cls(d.pop("mode"), backend=backend, **d, **kwargs)

    def with_world(self, world: int) -> "PartialShuffleSpec":
        """The same stream identity re-partitioned at a different world —
        what an elastic reshard commit produces (the fingerprint modulo
        ``world`` is unchanged)."""
        world = int(world)
        if world == self.world:
            return self
        wire = self.to_wire()
        wire["world"] = world
        return self.from_wire(wire, backend=self.backend)

    def fingerprint(self, *, include_world: bool = True) -> str:
        """Stable string of the wire form.  ``include_world=False`` names
        the stream identity independent of the current partition width —
        the membership-aware comparison elastic peers use."""
        wire = self.to_wire()
        if not include_world:
            wire.pop("world")
        return json.dumps(wire, sort_keys=True, separators=(",", ":"))

    def __eq__(self, other) -> bool:
        return (isinstance(other, PartialShuffleSpec)
                and self.fingerprint() == other.fingerprint())

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"{type(self).__name__}({self.fingerprint()})"


def _wire_key(k) -> list:
    return [list(k[0]), list(k[1]), list(k[2]), k[3], k[4]]

