"""Drop-in ``torch.utils.data.Sampler`` with on-GPU epoch-index regen.

Keeps the ``DistributedSampler`` contract (``torch/utils/data/
distributed.py``): ``__init__`` (a superset of its signature), ``__iter__``,
``__len__``, ``set_epoch``, so existing DDP DataLoader pipelines run
unchanged.  ``backend='cuda'`` (the default) generates each rank's index
tensor on the GPU with the hand-written kernels of ``ops/cuda_kernel.py``
and streams it back once per epoch; ``backend='cpu'`` runs the CPU
reference.

Beyond the reference surface:

* ``state_dict()`` / ``load_state_dict()`` — mid-epoch checkpoint/resume in
  the torchdata ``StatefulDataLoader`` convention.  The sampler counts what
  ``__iter__`` has yielded, so a bare ``state_dict()`` mid-epoch is already
  correct; ``state_dict(consumed=...)`` overrides when the training loop
  knows better.  The full permutation config rides along and is validated
  on load.  The format is the JAX package's: a checkpoint of either
  package's sampler resumes in the other.
* epoch *prefetch*: on the cuda backend ``set_epoch`` launches the regen
  and the device->host copy into pinned memory without waiting, so the
  card computes the next epoch's indices while the host finishes the
  current one; ``__iter__`` only waits on the copy's event.
"""

from __future__ import annotations

import threading
from typing import Optional, Union

import numpy as np
import torch
from torch.utils.data import Sampler

from ..ops import core
from ._chunked_iter import ChunkedIterMixin

#: written into new checkpoints.  v2 changed ONLY the §8 mixture slot
#: selection; every §1-§7 stream is bit-identical to v1, so v1 checkpoints
#: stay loadable.
SPEC_VERSION = 2
_ACCEPTED_SPEC_VERSIONS = (1, 2)


def _check_spec_version(state: dict) -> None:
    """Reject checkpoints from spec versions this build cannot reproduce."""
    v = state.get("spec_version", SPEC_VERSION)
    if v not in _ACCEPTED_SPEC_VERSIONS:
        raise ValueError(
            f"checkpoint from spec version {v}, this build implements "
            f"{_ACCEPTED_SPEC_VERSIONS}; the permutation law differs and "
            "silent reshuffling would occur"
        )


def _resolve_identity(num_replicas: Optional[int], rank: Optional[int]):
    """Mirror of the base-class identity discovery: fall back to
    torch.distributed only when args are omitted."""
    if num_replicas is not None and rank is not None:
        return int(num_replicas), int(rank)
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "num_replicas/rank not given and torch.distributed is not "
            "initialized; pass them explicitly"
        )
    world = dist.get_world_size() if num_replicas is None else int(num_replicas)
    r = dist.get_rank() if rank is None else int(rank)
    return world, r


class _AsyncRegen:
    """One in-flight host regen on a daemon thread.

    PyTorch's CPU ops release the GIL, so a ``set_epoch``-dispatched host
    regen overlaps the consumer's compute like the cuda backend's async
    launch.  Fork-safe: a child process inheriting a dead thread gets
    ``None`` from :meth:`result` and the caller regenerates synchronously."""

    def __init__(self, fn) -> None:
        self._result = None
        self._exc: Optional[BaseException] = None
        self._done = threading.Event()
        self._t = threading.Thread(target=self._run, args=(fn,),
                                   daemon=True, name="psds-regen-prefetch")
        self._t.start()

    def _run(self, fn) -> None:
        try:
            self._result = fn()
        except BaseException as exc:  # surfaced at result()
            self._exc = exc
        finally:
            self._done.set()

    def result(self):
        self._t.join()
        if not self._done.is_set():
            return None  # forked child: the thread never ran here
        if self._exc is not None:
            raise self._exc
        return self._result

    def discard(self) -> None:
        """Retire the worker without consuming its result: join the thread
        and drop any exception — nobody will ever read this regen."""
        self._t.join()
        self._result = None
        self._exc = None


class _DeviceRegen:
    """One in-flight device regen: the kernels' output on the card, its
    copy into a pinned host tensor (``non_blocking``), and the event
    recorded after the copy on the current stream."""

    def __init__(self, idx: torch.Tensor) -> None:
        self._idx = idx  # kept alive until the copy has landed
        self._host = torch.empty(idx.shape, dtype=idx.dtype, pin_memory=True)
        self._host.copy_(idx, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record()

    def result(self) -> np.ndarray:
        self._event.synchronize()
        self._idx = None
        return self._host.numpy()

    def discard(self) -> None:
        # no wait: PyTorch's pinned-memory allocator keeps the block until
        # the in-flight copy into it has finished
        self._idx = None


def _elastic_layers_from_state(el):
    """Normalize a checkpoint's elastic field to [(world, consumed), ...].

    Accepts the ``{"layers": [[w, c], ...]}`` cascade form and the
    single-reshard form ``{"old_world": w, "consumed": c}``."""
    if el is None:
        return None
    if "layers" in el:
        return [(int(w), int(c)) for w, c in el["layers"]]
    return [(int(el["old_world"]), int(el["consumed"]))]


class PartiallyShuffleDistributedSampler(ChunkedIterMixin, Sampler):
    """Partial-shuffle distributed sampler with on-GPU index generation.

    Parameters follow ``DistributedSampler`` (dataset, num_replicas, rank,
    shuffle, seed, drop_last) plus the partial-shuffle controls:

    window:        shuffle locality radius W (SPEC.md §3); indices move only
                   within W-sized windows (plus window-order permutation).
    order_windows: also permute the order of full windows (default True).
    partition:     'strided' (torch law) or 'blocked' (contiguous shards).
    backend:       'cuda' (default: the CUDA kernels on the current GPU; a
                   machine without a usable GPU raises
                   ``CudaUnavailableError`` here) or 'cpu' (the reference).
    rounds:        swap-or-not round count (SPEC.md §2); default 24.

    ``dataset`` may be any ``Sized`` or a plain ``int`` length.

    .. warning:: **Checkpointing with ``DataLoader(num_workers>0)``.**  The
       auto-tracked consumption counter counts indices the sampler has
       *yielded*; a multi-worker DataLoader prefetches indices ahead of the
       batches it delivers, so a bare ``state_dict()`` taken mid-epoch
       records samples as consumed that the model never trained on.  Wrap
       the loader in :class:`~partiallyshuffledistributedsampler_tpu_torch.
       sampler.stateful_loader.StatefulDataLoader`, or pass the trained-on
       count explicitly — ``sampler.state_dict(consumed=steps_done *
       batch_size)`` — whenever ``num_workers > 0``.
    """

    def __init__(
        self,
        dataset: Union[int, "object"],
        num_replicas: Optional[int] = None,
        rank: Optional[int] = None,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
        *,
        window: int = core.DEFAULT_WINDOW,
        order_windows: bool = True,
        partition: str = "strided",
        backend: str = "cuda",
        rounds: int = core.DEFAULT_ROUNDS,
    ) -> None:
        self.n = int(dataset) if isinstance(dataset, int) else len(dataset)
        self.num_replicas, self.rank = _resolve_identity(num_replicas, rank)
        if not 0 <= self.rank < self.num_replicas:
            raise ValueError(
                f"rank must be in [0, {self.num_replicas}), got {self.rank}"
            )
        self.shuffle = bool(shuffle)
        self.seed = int(seed)
        self.drop_last = bool(drop_last)
        self.window = int(window)
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        self.order_windows = bool(order_windows)
        if partition not in ("strided", "blocked"):
            raise ValueError(
                f"partition must be 'strided' or 'blocked', got {partition!r}"
            )
        self.partition = partition
        self.rounds = int(rounds)
        self.num_samples, self.total_size = core.shard_sizes(
            self.n, self.num_replicas, self.drop_last
        )
        self.epoch = 0
        self._offset = 0  # resume offset within the current epoch
        self._consumed = 0  # samples yielded so far this epoch (auto-tracked)
        self._generation = 0  # monotonic token: which iterator owns _consumed
        self._elastic = None  # remainder-epoch state after a world-size change
        from ..ops import ensure_index_backend

        ensure_index_backend(backend)
        self.backend = backend
        self._pending_epoch: Optional[int] = None
        self._pending = None  # in-flight _DeviceRegen / _AsyncRegen
        from ..utils.metrics import RegenTimer

        self.regen_timer = RegenTimer()  # per-epoch index-gen ms

    # ------------------------------------------------------------- generation
    def _law_kwargs(self) -> dict:
        return dict(shuffle=self.shuffle, drop_last=self.drop_last,
                    order_windows=self.order_windows,
                    partition=self.partition, rounds=self.rounds)

    def _generate_device(self, epoch: int) -> torch.Tensor:
        from ..ops.cuda import epoch_indices_cuda

        return epoch_indices_cuda(
            self.n, self.window, self.seed, epoch, self.rank,
            self.num_replicas, **self._law_kwargs(),
        )

    def epoch_indices(self, epoch: Optional[int] = None) -> np.ndarray:
        """This rank's full index order for ``epoch`` (default: current)."""
        with self.regen_timer.measure():
            return self._epoch_indices(epoch)

    def _epoch_indices(self, epoch: Optional[int]) -> np.ndarray:
        """The epoch's indices, from the ``set_epoch`` prefetch when it
        holds this epoch (the prefetch is consumed), else generated now."""
        e = self.epoch if epoch is None else int(epoch)
        # the elastic remainder regime applies only to the epoch being
        # resumed; an explicit other epoch is an ordinary full epoch
        if self._elastic is not None and e == self.epoch:
            return self._elastic_indices(e)
        if self._pending_epoch == e and self._pending is not None:
            arr = self._pending.result()
            self._pending = None
            self._pending_epoch = None
            if arr is not None:  # None: forked child, thread never ran
                return arr
        return self._generate_host(e)

    def _generate_host(self, epoch: int) -> np.ndarray:
        """The epoch's indices as a host array, through ``backend``."""
        from ..ops import epoch_indices_host

        return epoch_indices_host(
            self.backend, self.n, self.window, self.seed, epoch, self.rank,
            self.num_replicas, **self._law_kwargs(),
        )

    # ---------------------------------------------------------- Sampler API
    # __iter__ comes from ChunkedIterMixin: generation-token ownership +
    # chunked int-boxing.

    @property
    def _effective_num_samples(self) -> int:
        """num_samples, except on an elastic remainder epoch (SPEC.md §6)
        where this rank only carries its share of the un-consumed stream."""
        if self._elastic is not None:
            return self._elastic["num_samples"]
        return self.num_samples

    def __len__(self) -> int:
        # after load_state_dict mid-epoch the next __iter__ yields only the
        # remainder; report that so DataLoader length stays in sync
        return self._effective_num_samples - self._offset

    def _retire_pending(self) -> None:
        stale, self._pending = self._pending, None
        self._pending_epoch = None
        if stale is not None:
            stale.discard()  # never abandon a live prefetch

    def set_epoch(self, epoch: int) -> None:
        """Set the epoch for deterministic reshuffling.  On the cuda backend
        this *launches* the regen and its copy to the host at once, without
        waiting, overlapping them with whatever the host does next.

        Moving to a *different* epoch also resets the resume offset and the
        consumed counter and ends any elastic remainder epoch."""
        e = int(epoch)
        if e != self.epoch:
            # a generator still draining the previous epoch is now stale
            self._generation += 1
            self._elastic = None
            self._offset = 0
            self._consumed = 0
        self.epoch = e
        if self._elastic is not None:
            return  # remainder epoch regenerates on demand in __iter__
        if self._pending_epoch == e and self._pending is not None:
            return  # this epoch's prefetch is already in flight
        self._retire_pending()
        if self.backend == "cuda":
            self._pending = _DeviceRegen(self._generate_device(e))
        else:
            self._pending = _AsyncRegen(lambda: self._generate_host(e))
        self._pending_epoch = e

    # ------------------------------------------------------ elastic reshard
    def _compute_elastic(self, layers) -> dict:
        """Validate and describe a cascade of reshard layers (SPEC.md §6).
        Pure — mutates nothing."""
        chain, remaining, num_samples = core.elastic_chain(
            self.n, layers, self.num_replicas, self.drop_last
        )
        return {
            "chain": chain,
            "remaining": remaining,
            "num_samples": num_samples,
        }

    def _install_elastic(self, layers) -> None:
        self._elastic = self._compute_elastic(layers)
        self._retire_pending()

    def _elastic_indices(self, epoch: int) -> np.ndarray:
        """This rank's share of the remainder epoch, computed once per epoch
        and cached (DataLoader re-enters ``__iter__``)."""
        el = self._elastic
        cached = el.get("_cache")
        if cached is not None and cached[0] == epoch:
            return cached[1]
        if el["remaining"] == 0:
            return np.empty(0, dtype=np.int32 if self.n <= core.INT32_MAX
                            else np.int64)
        if self.backend == "cuda":
            from ..ops.cuda import elastic_indices_cuda

            arr = elastic_indices_cuda(
                self.n, self.window, self.seed, epoch, self.rank,
                self.num_replicas, el["num_samples"], el["chain"],
                shuffle=self.shuffle, order_windows=self.order_windows,
                partition=self.partition, rounds=self.rounds,
            ).cpu().numpy()
        else:
            from ..ops.cpu import elastic_indices_cpu

            arr = elastic_indices_cpu(
                self.n, self.window, self.seed, epoch, self.rank,
                self.num_replicas,
                [(w, c) for (w, _ns, c) in el["chain"]],
                **self._law_kwargs(),
            ).numpy()
        # shared across __iter__ calls and epoch_indices(): read-only
        arr.setflags(write=False)
        el["_cache"] = (epoch, arr)
        return arr

    @classmethod
    def reshard_from_state_dict(
        cls,
        state: dict,
        num_replicas: int,
        rank: int,
        *,
        dataset=None,
        **kwargs,
    ):
        """Resume a checkpointed run at a *different* world size (SPEC.md §6).

        Builds a sampler for the new ``(num_replicas, rank)`` with the
        checkpoint's permutation config, positioned so the current epoch's
        un-consumed samples — and only those — are served this epoch, split
        across the new ranks.  From the next ``set_epoch`` on it behaves as
        an ordinary sampler of the new world size.
        """
        _check_spec_version(state)
        for f in ("num_replicas", "offset", "n", "seed", "epoch"):
            if f not in state:
                raise ValueError(
                    f"state_dict lacks {f!r}; elastic reshard needs a "
                    "checkpoint written by this library (spec >= 1)"
                )
        sampler = cls(
            int(state["n"]) if dataset is None else dataset,
            num_replicas=num_replicas,
            rank=rank,
            shuffle=state.get("shuffle", True),
            seed=int(state["seed"]),
            drop_last=state.get("drop_last", False),
            window=int(state.get("window", core.DEFAULT_WINDOW)),
            order_windows=state.get("order_windows", True),
            partition=state.get("partition", "strided"),
            rounds=int(state.get("rounds", core.DEFAULT_ROUNDS)),
            **kwargs,
        )
        if sampler.n != int(state["n"]):
            raise ValueError(
                f"dataset length {sampler.n} != checkpoint n {state['n']}"
            )
        sampler.epoch = int(state["epoch"])
        # a checkpoint taken mid-remainder-epoch just deepens the cascade
        layers = _elastic_layers_from_state(state.get("elastic")) or []
        layers = layers + [(int(state["num_replicas"]), int(state["offset"]))]
        sampler._install_elastic(layers)
        return sampler

    # ------------------------------------------------------ checkpoint/resume
    #: permutation-defining fields carried in state_dict and validated on
    #: load
    _CONFIG_FIELDS = (
        "n", "num_replicas", "window", "rounds", "order_windows",
        "partition", "shuffle", "drop_last",
    )

    def state_dict(self, consumed: Optional[int] = None) -> dict:
        """Snapshot sampler state.  ``consumed`` defaults to the number of
        samples ``__iter__`` has yielded this epoch (auto-tracked)."""
        state = {
            "spec_version": SPEC_VERSION,
            "kind": "single",
            "seed": self.seed,
            "epoch": self.epoch,
            "offset": int(self._consumed if consumed is None else consumed),
        }
        for f in self._CONFIG_FIELDS:
            state[f] = getattr(self, f)
        if self._elastic is not None:
            state["elastic"] = {
                "layers": [
                    [w, c] for (w, _ns, c) in self._elastic["chain"]
                ],
            }
        return state

    def load_state_dict(self, state: dict) -> None:
        _check_spec_version(state)
        if state.get("kind", "single") != "single":
            raise ValueError(
                f"checkpoint kind {state['kind']!r} cannot resume a "
                "single-source sampler"
            )
        for f in self._CONFIG_FIELDS:
            if f in state and state[f] != getattr(self, f):
                raise ValueError(
                    f"checkpoint was written with {f}={state[f]!r} but this "
                    f"sampler has {f}={getattr(self, f)!r}; the offset would "
                    "resume into a different permutation (for a deliberate "
                    "world-size change use reshard_from_state_dict)"
                )
        # validate EVERYTHING before assigning anything: a failed load must
        # leave the sampler exactly as it was
        layers = _elastic_layers_from_state(state.get("elastic"))
        elastic = self._compute_elastic(layers) if layers else None
        effective = elastic["num_samples"] if elastic else self.num_samples
        offset = int(state.get("offset", 0))
        if not 0 <= offset <= effective:
            raise ValueError(f"offset {offset} outside [0, {effective}]")
        self.seed, self.epoch = int(state["seed"]), int(state["epoch"])
        self._elastic = elastic
        # the prefetch buffer was launched under the PREVIOUS (seed, epoch)
        self._retire_pending()
        self._offset = offset
        self._consumed = offset
        self._generation += 1  # a draining pre-load generator must not count
