"""Weighted mixture sampler (SPEC.md §8): the multi-corpus pretrain shape.

``PartialShuffleMixtureSampler`` is the mixture sibling of
``PartiallyShuffleDistributedSampler`` for S weighted sources: it yields
*global ids* into the concatenated id space (source s's ids live at
``[base_s, base_s + n_s)``), interleaved at exact per-block proportions,
each source partially shuffled by its own windowed permutation.  Same
contract otherwise: ``set_epoch``/``__len__``/``__iter__``,
``state_dict``/``load_state_dict`` with config validation,
``reshard_from_state_dict``, strided/blocked rank partition,
deterministic in ``(seed, epoch)``.  The checkpoint format is the JAX
package's: a checkpoint of either package's mixture sampler resumes in the
other.

``backend='cuda'`` (the default) generates each epoch's ids on the GPU
with the mixture kernels (``ops/mixture.py``) and streams them back once
per epoch: ``set_epoch`` launches the regen and a pinned, non-blocking
device->host copy.  ``backend='cpu'`` runs the plain law on the host,
``backend='native'`` the C++ host kernel, and ``backend='auto'`` resolves
to the host backend (native when it loads, else cpu).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.utils.data import Sampler

from ..ops import core, ensure_index_backend, resolve_host_backend
from ..ops.mixture import (
    DEFAULT_BLOCK,
    MixtureSpec,
    mixture_elastic_indices_cuda,
    mixture_epoch_indices_cuda,
    mixture_epoch_sizes,
)
from ._chunked_iter import ChunkedIterMixin
from .torch_shim import (
    SPEC_VERSION,
    _AsyncRegen,
    _check_spec_version,
    _DeviceRegen,
    _elastic_layers_from_state,
    _resolve_identity,
)


class PartialShuffleMixtureSampler(ChunkedIterMixin, Sampler):
    """Distributed weighted-mixture sampler over S sources.

    sources:       per-source sizes ``n_s`` (or Sized datasets).
    weights:       integer weights (proportions ``v_s / sum(v)``).
    windows:       per-source window list or one shared int (§8; default
                   ``DEFAULT_WINDOW`` capped at each source size).
    block:         mixing block size B: every aligned B-block matches the
                   quotas exactly (§8.1-8.2).
    epoch_samples: mixture-epoch length T (default ``sum n_s``).  Sources
                   whose weighted share exceeds their size repeat with a
                   fresh permutation per pass.
    backend:       'cuda' (default: the mixture kernels on the current GPU;
                   a machine without a usable GPU raises
                   ``CudaUnavailableError`` here), 'cpu' (the plain law
                   on the host), 'native' (the C++ host kernel) or 'auto'
                   (the host backend: 'native' when it loads, else 'cpu';
                   the cost model prices only the single-source law).
                   Each prefetches on ``set_epoch``.

    Yields python ints (global ids).  ``decompose(ids)`` maps ids back to
    (source_id, local_id).
    """

    def __init__(
        self,
        sources,
        weights,
        *,
        num_replicas: Optional[int] = None,
        rank: Optional[int] = None,
        seed: int = 0,
        windows=None,
        block: int = DEFAULT_BLOCK,
        epoch_samples: Optional[int] = None,
        shuffle: bool = True,
        drop_last: bool = False,
        order_windows: bool = True,
        partition: str = "strided",
        backend: str = "cuda",
        rounds: int = core.DEFAULT_ROUNDS,
        pattern_version: int = 2,
    ) -> None:
        sizes = [
            int(s) if isinstance(s, (int, np.integer)) else len(s)
            for s in sources
        ]
        self.spec = MixtureSpec(sizes, weights, windows=windows, block=block,
                                pattern_version=pattern_version)
        self.num_replicas, self.rank = _resolve_identity(num_replicas, rank)
        if not 0 <= self.rank < self.num_replicas:
            raise ValueError(
                f"rank must be in [0, {self.num_replicas}), got {self.rank}"
            )
        self.seed = int(seed)
        self.shuffle = bool(shuffle)
        self.drop_last = bool(drop_last)
        self.order_windows = bool(order_windows)
        if partition not in ("strided", "blocked"):
            raise ValueError(
                f"partition must be 'strided' or 'blocked', got {partition!r}"
            )
        self.partition = partition
        if backend == "auto":
            backend = resolve_host_backend()
        ensure_index_backend(backend)  # fail at construction, not epoch 1
        self.backend = backend
        self.rounds = int(rounds)
        self.epoch_samples = (
            None if epoch_samples is None else int(epoch_samples)
        )
        self.T, self.num_samples, self.total_size = mixture_epoch_sizes(
            self.spec, self.epoch_samples, self.num_replicas, self.drop_last
        )
        # surface the strided-orbit starvation hazard at construction
        # (v1 / unshuffled streams only; v2 rotation is immune)
        self.spec.check_rank_balance(self.rank, self.num_replicas,
                                     self.partition, self.shuffle)
        self.epoch = 0
        self._offset = 0
        self._consumed = 0
        self._generation = 0
        self._elastic = None  # remainder-epoch state after a world change
        self._pending = None  # in-flight _DeviceRegen / _AsyncRegen
        self._pending_epoch: Optional[int] = None
        from ..utils.metrics import RegenTimer

        self.regen_timer = RegenTimer()

    # ------------------------------------------------------------ generation
    def _kwargs(self) -> dict:
        return dict(
            epoch_samples=self.epoch_samples, shuffle=self.shuffle,
            drop_last=self.drop_last, order_windows=self.order_windows,
            partition=self.partition, rounds=self.rounds,
        )

    def _generate(self, epoch: int) -> torch.Tensor:
        """The epoch's ids on the card (launched, not waited for) or, on
        'cpu', by the plain law on the host."""
        return mixture_epoch_indices_cuda(
            self.spec, self.seed, epoch, self.rank, self.num_replicas,
            device=self.backend, **self._kwargs(),
        )

    def _generate_host(self, epoch: int) -> np.ndarray:
        """The epoch's ids as a host array, through ``backend``."""
        if self.backend == "native":
            from ..ops.native import mixture_epoch_indices_native

            return mixture_epoch_indices_native(
                self.spec, self.seed, epoch, self.rank, self.num_replicas,
                **self._kwargs())
        return self._generate(epoch).cpu().numpy()

    def epoch_indices(self, epoch: Optional[int] = None) -> np.ndarray:
        """This rank's global-id order for ``epoch`` (default: current)."""
        e = self.epoch if epoch is None else int(epoch)
        # the elastic remainder regime applies only to the epoch being
        # resumed; an explicit other epoch is an ordinary full epoch
        if self._elastic is not None and e == self.epoch:
            return self._elastic_indices(e)
        with self.regen_timer.measure():
            if self._pending_epoch == e and self._pending is not None:
                arr = self._pending.result()
                self._pending = None
                self._pending_epoch = None
                if arr is not None:  # None: forked child, thread never ran
                    return arr
            return self._generate_host(e)

    def decompose(self, global_ids):
        """(source_id, local_id) arrays for served global ids."""
        return self.spec.decompose(global_ids)

    # ------------------------------------------------------ elastic reshard
    # The same plumbing as the single-source sampler's (validate before
    # mutating, the epoch-keyed cache, the cascade append) over the §8
    # stream: a fix to one belongs in both.
    def _compute_elastic(self, layers) -> dict:
        """Size and validate a reshard cascade over the mixture-epoch
        length (SPEC.md §6 over §8).  Pure."""
        chain, remaining, num_samples = core.elastic_chain(
            self.T, layers, self.num_replicas, self.drop_last
        )
        return {
            "layers": [(w, c) for (w, _ns, c) in chain],
            "remaining": remaining,
            "num_samples": num_samples,
        }

    def _elastic_indices(self, epoch: int) -> np.ndarray:
        el = self._elastic
        cached = el.get("_cache")
        if cached is not None and cached[0] == epoch:
            return cached[1]
        with self.regen_timer.measure():
            if self.backend == "native":
                from ..ops.native import mixture_elastic_indices_native

                arr = mixture_elastic_indices_native(
                    self.spec, self.seed, epoch, self.rank,
                    self.num_replicas, el["layers"], **self._kwargs())
            else:
                arr = mixture_elastic_indices_cuda(
                    self.spec, self.seed, epoch, self.rank,
                    self.num_replicas, el["layers"], device=self.backend,
                    **self._kwargs(),
                ).cpu().numpy()
        arr.setflags(write=False)  # shared across __iter__ calls: read-only
        el["_cache"] = (epoch, arr)
        return arr

    def _retire_pending(self) -> None:
        stale, self._pending = self._pending, None
        self._pending_epoch = None
        if stale is not None:
            stale.discard()  # never abandon a live prefetch

    @classmethod
    def reshard_from_state_dict(cls, state: dict, num_replicas: int,
                                rank: int, **kwargs):
        """Resume a mixture checkpoint at a different world size: the
        current epoch's un-consumed mixture stream, and only that, is
        served this epoch, split across the new ranks (SPEC.md §6 over §8);
        from the next ``set_epoch`` on, an ordinary sampler."""
        if state.get("kind") != "mixture":
            raise ValueError(
                f"checkpoint kind {state.get('kind')!r} is not a mixture "
                "checkpoint"
            )
        _check_spec_version(state)
        for f in ("sources", "weights", "num_replicas", "offset", "seed",
                  "epoch"):
            if f not in state:
                raise ValueError(f"state_dict lacks {f!r}")
        sampler = cls(
            list(state["sources"]), list(state["weights"]),
            num_replicas=num_replicas, rank=rank,
            seed=int(state["seed"]),
            windows=list(state.get("windows")) if state.get("windows")
            else None,
            block=int(state.get("block", DEFAULT_BLOCK)),
            epoch_samples=state.get("epoch_samples"),
            shuffle=state.get("shuffle", True),
            drop_last=state.get("drop_last", False),
            order_windows=state.get("order_windows", True),
            partition=state.get("partition", "strided"),
            rounds=int(state.get("rounds", core.DEFAULT_ROUNDS)),
            # absent in v1-build checkpoints, whose streams are the static
            # pattern: resharding must reproduce exactly that stream
            pattern_version=int(state.get("pattern_version", 1)),
            **kwargs,
        )
        if "windows" in state and list(state["windows"]) != list(
            sampler.spec.windows
        ):
            # an uncapped list-form window of a v1 build routed its source
            # through the pure-tail bijection: a stream this law caps away
            raise ValueError(
                f"checkpoint windows {list(state['windows'])} cannot be "
                f"reproduced: this build caps windows at each source size "
                f"(-> {list(sampler.spec.windows)}); the remainder stream "
                "would not match the consumed prefix"
            )
        sampler.epoch = int(state["epoch"])
        layers = _elastic_layers_from_state(state.get("elastic")) or []
        layers = layers + [(int(state["num_replicas"]), int(state["offset"]))]
        sampler._elastic = sampler._compute_elastic(layers)
        sampler._retire_pending()
        return sampler

    # ---------------------------------------------------------- Sampler API
    # __iter__ from ChunkedIterMixin (shared with the single-source sampler)

    @property
    def _effective_num_samples(self) -> int:
        if self._elastic is not None:
            return self._elastic["num_samples"]
        return self.num_samples

    def __len__(self) -> int:
        return self._effective_num_samples - self._offset

    def set_epoch(self, epoch: int) -> None:
        """Set the epoch.  On the cuda backend this *launches* the regen
        and its copy to the host at once, without waiting.  Moving to a
        different epoch resets the resume offset and the consumed counter
        and ends any elastic remainder epoch."""
        e = int(epoch)
        if e != self.epoch:
            self._generation += 1
            self._elastic = None  # the remainder regime ends with its epoch
            self._offset = 0
            self._consumed = 0
        self.epoch = e
        if self._elastic is not None:
            return  # remainder epoch regenerates on demand in __iter__
        if self._pending_epoch == e and self._pending is not None:
            return  # this epoch's prefetch is already in flight
        self._retire_pending()
        if self.backend == "cuda":
            self._pending = _DeviceRegen(self._generate(e))
        else:
            self._pending = _AsyncRegen(lambda: self._generate_host(e))
        self._pending_epoch = e

    # ------------------------------------------------------ checkpoint state
    #: §8 permutation-defining fields validated on load
    _CONFIG_FIELDS = (
        "num_replicas", "shuffle", "drop_last", "order_windows",
        "partition", "rounds", "epoch_samples",
    )

    def state_dict(self, consumed: Optional[int] = None) -> dict:
        """Snapshot sampler state.  ``consumed`` defaults to the number of
        ids ``__iter__`` has yielded this epoch."""
        state = {
            "spec_version": SPEC_VERSION,
            "kind": "mixture",
            "sources": list(self.spec.sources),
            "weights": list(self.spec.weights),
            "windows": list(self.spec.windows),
            "block": self.spec.block,
            "pattern_version": self.spec.pattern_version,
            "seed": self.seed,
            "epoch": self.epoch,
            "offset": int(self._consumed if consumed is None else consumed),
        }
        for f in self._CONFIG_FIELDS:
            state[f] = getattr(self, f)
        if self._elastic is not None:
            state["elastic"] = {
                "layers": [[w, c] for (w, c) in self._elastic["layers"]],
            }
        return state

    def load_state_dict(self, state: dict) -> None:
        _check_spec_version(state)
        if state.get("kind") != "mixture":
            # a single-source checkpoint's fields appear in none of the
            # guards below: it would load and resume another stream
            raise ValueError(
                f"checkpoint kind {state.get('kind')!r} is not a mixture "
                "checkpoint; it cannot resume a PartialShuffleMixtureSampler"
            )
        spec_fields = {
            "sources": list(self.spec.sources),
            "weights": list(self.spec.weights),
            "windows": list(self.spec.windows),
            "block": self.spec.block,
        }
        for f, mine in spec_fields.items():
            if f in state and list(np.atleast_1d(state[f])) != list(
                np.atleast_1d(mine)
            ):
                raise ValueError(
                    f"checkpoint was written with {f}={state[f]!r} but this "
                    f"sampler has {f}={mine!r}; the offset would resume into "
                    "a different mixture stream"
                )
        # a checkpoint without the field was written by a v1 build, whose
        # stream is the static-pattern law: missing means 1
        ckpt_pv = int(state.get("pattern_version", 1))
        if ckpt_pv != self.spec.pattern_version:
            raise ValueError(
                f"checkpoint was written with pattern_version={ckpt_pv} but "
                f"this sampler has {self.spec.pattern_version}; construct "
                f"the sampler with pattern_version={ckpt_pv} to resume it"
            )
        for f in ("seed", "epoch"):
            if f not in state:
                raise ValueError(f"state_dict lacks {f!r}")
        for f in self._CONFIG_FIELDS:
            if f in state and state[f] != getattr(self, f):
                raise ValueError(
                    f"checkpoint was written with {f}={state[f]!r} but this "
                    f"sampler has {f}={getattr(self, f)!r}"
                )
        # validate everything before assigning anything: a failed load
        # leaves the sampler untouched
        layers = _elastic_layers_from_state(state.get("elastic"))
        elastic = self._compute_elastic(layers) if layers else None
        effective = elastic["num_samples"] if elastic else self.num_samples
        offset = int(state.get("offset", 0))
        if not 0 <= offset <= effective:
            raise ValueError(f"offset {offset} outside [0, {effective}]")
        self.seed = int(state["seed"])
        self.epoch = int(state["epoch"])
        self._elastic = elastic
        # the prefetch was launched under the previous (seed, epoch)
        self._retire_pending()
        self._offset = offset
        self._consumed = offset
        self._generation += 1
