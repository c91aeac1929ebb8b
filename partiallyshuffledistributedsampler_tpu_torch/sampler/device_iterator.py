"""Device-resident epoch iteration: indices never leave the GPU.

The sampler streams indices to the host because torch Datasets live
there.  A pipeline whose data already sits on the card does not need
that: the epoch index tensor stays on the device and each step's batch
is a view of it, gathered inside the train step.  This module packages
that pattern, with next-epoch prefetch, for one dataset
(``DeviceEpochIterator``) and for a weighted mixture of datasets
(``MixtureEpochIterator``).

``run_epoch`` and ``run_epochs`` drive a step function over an epoch's (or
several epochs') batches: the JAX package compiles them into one program
with ``lax.scan``; here they are Python loops over the batch views, with
the same ``steps``/``collect``/``on_tail`` contract.  Each epoch's indices
come from one kernel regen (``epoch_indices_cuda`` /
``mixture_epoch_indices_cuda``), launched ahead of the epoch before it.
"""

from __future__ import annotations

from typing import Iterator, Optional

import torch

from ..ops import core, ensure_index_backend
from ..ops.cuda import elastic_indices_cuda, epoch_indices_cuda
from ..ops.mixture import (
    MixtureSpec,
    mixture_elastic_indices_cuda,
    mixture_epoch_indices_cuda,
    mixture_epoch_sizes,
)


def batch_index_window(epoch_idx: torch.Tensor, step: int,
                       batch: int) -> torch.Tensor:
    """The step's index window as a view: ``epoch_idx`` is [num_samples]
    (one rank) or [dp, num_samples]."""
    s = int(step) * int(batch)
    return epoch_idx[..., s:s + int(batch)]


class DeviceEpochIterator:
    """Per-epoch, per-step index batches with next-epoch prefetch.

        it = DeviceEpochIterator(n=1_000_000, window=8192, batch=512,
                                 seed=0, rank=0, world=8)
        for epoch in range(E):
            for idx_batch in it.epoch(epoch):   # CUDA int32[batch] view
                loss = train_step(model, data, idx_batch)

    ``epoch()`` launches epoch e+1's regen before yielding e's first batch,
    so the next epoch's permutation is computed on the card while this
    epoch trains.  A batch is a view ``idx[s*b:(s+1)*b]`` of the epoch
    tensor: serving a step costs a slice, no launch and no copy.
    ``device='cpu'`` runs the same law on the host (the CPU tests use it).
    """

    def __init__(
        self,
        n: int,
        window: int,
        batch: int,
        *,
        seed: int = 0,
        rank: int = 0,
        world: int = 1,
        drop_last_batch: bool = True,
        prefetch_next_epoch: bool = True,
        device="cuda",
        **kwargs,
    ) -> None:
        if not 0 <= rank < world:
            raise ValueError(f"rank must be in [0, {world}), got {rank}")
        self.device = torch.device(device)
        ensure_index_backend(self.device.type)
        self.n, self.window, self.batch = n, window, batch
        self.seed, self.rank, self.world = seed, rank, world
        self.kwargs = kwargs
        self.num_samples, _ = core.shard_sizes(
            n, world, kwargs.get("drop_last", False)
        )
        self.drop_last_batch = bool(drop_last_batch)
        if drop_last_batch:
            self.steps_per_epoch = self.num_samples // batch
        else:
            self.steps_per_epoch = -(-self.num_samples // batch)
        if self.steps_per_epoch == 0:
            raise ValueError(
                f"batch={batch} exceeds the rank's {self.num_samples} samples"
            )
        self.prefetch_next_epoch = prefetch_next_epoch
        self._cache: dict[int, torch.Tensor] = {}

    def _regen(self, epoch: int) -> torch.Tensor:
        return epoch_indices_cuda(
            self.n, self.window, self.seed, epoch, self.rank, self.world,
            device=self.device, **self.kwargs,
        )

    def epoch_array(self, epoch: int) -> torch.Tensor:
        arr = self._cache.pop(epoch, None)
        if arr is None:
            arr = self._regen(epoch)
        return arr

    def _prefetch(self, epoch: int) -> None:
        # launched without waiting: the card works on it behind this
        # epoch's steps
        self._cache[epoch + 1] = self._regen(epoch + 1)
        if len(self._cache) > 2:  # bound memory if epochs are skipped
            for k in sorted(self._cache)[:-2]:
                del self._cache[k]

    def epoch(self, epoch: int) -> Iterator[torch.Tensor]:
        epoch = int(epoch)
        # entries below the epoch being served can never be served again
        for k in [k for k in self._cache if k < epoch]:
            del self._cache[k]
        idx = self.epoch_array(epoch)
        if self.prefetch_next_epoch:
            self._prefetch(epoch)
        yield from self._serve(idx)

    def _serve(self, idx: torch.Tensor) -> Iterator[torch.Tensor]:
        """An index tensor as per-step views: the whole batches, then
        (``drop_last_batch=False``) the trailing partial batch."""
        whole = idx.shape[0] // self.batch
        for s in range(whole):
            yield batch_index_window(idx, s, self.batch)
        if idx.shape[0] > whole * self.batch and not self.drop_last_batch:
            yield idx[whole * self.batch:]

    def elastic_epoch_array(self, epoch: int, layers) -> torch.Tensor:
        """This rank's remainder-epoch indices after a world-size change
        (SPEC.md §6): build the iterator at the NEW ``(rank, world)`` and
        pass the checkpoint cascade ``[(old_world, consumed), ...]``
        outermost first.  Equal to the sampler's
        ``reshard_from_state_dict`` stream for the same layers."""
        chain, remaining, ns = core.elastic_chain(
            self.n, layers, self.world, self.kwargs.get("drop_last", False)
        )
        if remaining == 0 or ns == 0:
            return torch.empty(0, dtype=core.out_dtype(self.n),
                               device=self.device)
        return elastic_indices_cuda(
            self.n, self.window, self.seed, epoch, self.rank, self.world,
            ns, chain,
            shuffle=self.kwargs.get("shuffle", True),
            order_windows=self.kwargs.get("order_windows", True),
            partition=self.kwargs.get("partition", "strided"),
            rounds=self.kwargs.get("rounds", core.DEFAULT_ROUNDS),
            device=self.device,
        )

    def elastic_epoch(self, epoch: int, layers) -> Iterator[torch.Tensor]:
        """Per-step batches of the remainder epoch (SPEC.md §6), served as
        :meth:`epoch` serves a full one.  After it, continue with ordinary
        :meth:`epoch` calls: the next epoch is a full epoch at the new
        world size."""
        yield from self._serve(self.elastic_epoch_array(epoch, layers))

    # ----------------------------------------------------------- runners
    def _tail_plan(self, on_tail: str, steps, collect: bool) -> int:
        """Validate the runners' tail-batch contract and return the length
        of the trailing partial batch to run (0 = none).

        A trailing partial batch exists only with ``drop_last_batch=False``.
        ``on_tail='error'`` (default) refuses to run, naming the choices;
        ``'run'`` runs one extra ``step_fn(carry, tail_idx)`` step after the
        whole batches (not with ``collect=True``, whose outputs stack, nor
        with a ``steps`` cap, which would skip the batches in between);
        ``'drop'`` runs whole batches only.  The JAX package's contract,
        errors included."""
        if on_tail not in ("error", "run", "drop"):
            raise ValueError(
                f"on_tail must be 'error', 'run' or 'drop', got {on_tail!r}"
            )
        tail = self.num_samples % self.batch
        if tail == 0 or self.drop_last_batch:
            return 0
        if on_tail == "error":
            raise ValueError(
                f"this iterator serves a trailing partial batch of {tail} "
                f"(drop_last_batch=False) which a scanned runner cannot "
                f"carry; pass on_tail='run' to fuse it as one extra step, "
                f"on_tail='drop' to scan whole batches only, or use epoch()"
            )
        if on_tail == "drop":
            return 0
        if collect:
            raise ValueError(
                "on_tail='run' is incompatible with collect=True: the tail "
                "step's output cannot stack with the scanned ys — use "
                "on_tail='drop' and run the tail through epoch(), or "
                "collect=False"
            )
        if steps is not None:
            raise ValueError(
                "on_tail='run' requires steps=None: a capped scan followed "
                "by the tail would silently skip the batches in between"
            )
        return tail

    def _run_steps(self, idx: torch.Tensor, step_fn, carry, nsteps: int,
                   tail: int, collect: bool):
        """``step_fn`` over the first ``nsteps`` batch views of ``idx``,
        then the ``tail`` partial batch; ``(carry, ys)``."""
        ys = []
        for s in range(nsteps):
            out = step_fn(carry, batch_index_window(idx, s, self.batch))
            if collect:
                carry, y = out
                ys.append(y)
            else:
                carry = out
        if tail:
            start = (self.num_samples // self.batch) * self.batch
            carry = step_fn(carry, idx[start:start + tail])
        return carry, (_stack(ys) if collect and ys else None)

    def run_epoch(self, epoch: int, step_fn, carry, *,
                  steps: Optional[int] = None, collect: bool = False,
                  on_tail: str = "error"):
        """Run an epoch's training steps: ``step_fn(carry, idx_batch) ->
        carry`` (or, with ``collect=True``, ``-> (carry, y)``, and the
        ``y``s come back stacked beside the final carry).  ``steps`` caps
        the step count; the default is every whole batch, and a trailing
        partial batch follows ``on_tail`` (``_tail_plan``).  The next
        epoch's regen is launched before the first step, as ``epoch()``
        does.  Everything is validated before any regen is launched."""
        whole = self.num_samples // self.batch
        tail = self._tail_plan(on_tail, steps, collect)
        nsteps = whole if steps is None else int(steps)
        if not (0 < nsteps <= whole or (nsteps == 0 and tail)):
            raise ValueError(
                f"steps={nsteps} not in [1, {whole}]"
                " (only whole batches can be scanned)"
            )
        arr = self.epoch_array(epoch)
        if self.prefetch_next_epoch:
            self._prefetch(epoch)
        carry, ys = self._run_steps(arr, step_fn, carry, nsteps, tail,
                                    collect)
        return (carry, ys) if collect else carry

    def run_epochs(self, first_epoch: int, n_epochs: int, step_fn, carry,
                   *, collect: bool = False, on_tail: str = "error"):
        """Run ``n_epochs`` whole epochs from ``first_epoch``: each epoch
        regenerates through the kernels once (the iterator's cache is not
        consulted), launched while the epoch before it runs, then
        ``step_fn`` runs over its batches as in :meth:`run_epoch`.  With
        ``collect=True`` the outputs stack to ``[n_epochs, steps, ...]``."""
        whole = self.num_samples // self.batch
        tail = self._tail_plan(on_tail, None, collect)
        if whole == 0 and not tail:
            raise ValueError("batch exceeds the rank's whole-batch budget")
        if int(n_epochs) < 1:
            raise ValueError(f"n_epochs must be >= 1, got {n_epochs}")
        first = int(first_epoch)
        ys = []
        nxt = self._regen(first)
        for e in range(first, first + int(n_epochs)):
            idx = nxt
            if e + 1 < first + int(n_epochs):
                nxt = self._regen(e + 1)  # on the card behind this epoch
            carry, y = self._run_steps(idx, step_fn, carry, whole, tail,
                                       collect)
            ys.append(y)
        return (carry, _stack(ys)) if collect else carry


def _stack(ys: list):
    """Stack per-step outputs along a new leading axis: tensors with
    ``torch.stack``, numbers as tensors, tuples, lists and dicts leaf by
    leaf (the shapes ``lax.scan`` stacks)."""
    first = ys[0]
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([y[i] for y in ys])
                           for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _stack([y[k] for y in ys]) for k in first}
    return torch.stack([torch.as_tensor(y) for y in ys])


class MixtureEpochIterator(DeviceEpochIterator):
    """:class:`DeviceEpochIterator` over a weighted mixture (SPEC.md §8).

        it = MixtureEpochIterator(spec, batch=512, seed=0, rank=r, world=w)
        for epoch in range(E):
            state, losses = it.run_epoch(epoch, step, state, collect=True)

    The same drive modes and contracts as the single-source iterator
    (``epoch()`` with next-epoch prefetch, ``run_epoch``, ``run_epochs``,
    ``elastic_epoch``), with the epoch index tensor holding mixture
    *global ids* (``spec.decompose`` splits them).  The §4/§8.4 length
    laws coincide, so the sizing is inherited with ``n = T``.  Each regen
    launches the mixture kernels on the card.
    """

    @property
    def windows(self) -> tuple:
        """Per-source §8 windows (the spec's)."""
        return self.spec.windows

    @property
    def window(self):
        """A mixture has no single window: refuse rather than publish the
        base class's placeholder."""
        raise AttributeError(
            "a mixture iterator has no single window; use .windows "
            "(per-source, from the spec)"
        )

    @window.setter
    def window(self, value) -> None:
        # the base-class __init__ writes its placeholder once; swallow
        # exactly that, refuse user writes
        if getattr(self, "_window_sealed", False):
            raise AttributeError(
                "a mixture iterator has no single window to set; the "
                "per-source windows live on the spec"
            )

    def __init__(
        self,
        spec,
        batch: int,
        *,
        seed: int = 0,
        rank: int = 0,
        world: int = 1,
        epoch_samples: Optional[int] = None,
        drop_last_batch: bool = True,
        prefetch_next_epoch: bool = True,
        device="cuda",
        **kwargs,
    ) -> None:
        if not isinstance(spec, MixtureSpec):
            raise TypeError(
                f"spec must be a MixtureSpec, got {type(spec).__name__}"
            )
        self.spec = spec
        self.epoch_samples = (
            None if epoch_samples is None else int(epoch_samples)
        )
        T, _, _ = mixture_epoch_sizes(
            spec, epoch_samples, world, kwargs.get("drop_last", False)
        )
        super().__init__(
            T, 1, batch, seed=seed, rank=rank, world=world,
            drop_last_batch=drop_last_batch,
            prefetch_next_epoch=prefetch_next_epoch, device=device,
            **kwargs,
        )
        # surface the strided-orbit starvation hazard at construction
        # (v1 / unshuffled streams only; v2 rotation is immune)
        spec.check_rank_balance(
            rank, world, self.kwargs.get("partition", "strided"),
            self.kwargs.get("shuffle", True),
        )
        self._window_sealed = True

    def _regen(self, epoch: int) -> torch.Tensor:
        return mixture_epoch_indices_cuda(
            self.spec, self.seed, epoch, self.rank, self.world,
            epoch_samples=self.epoch_samples, device=self.device,
            **self.kwargs,
        )

    def elastic_epoch_array(self, epoch: int, layers) -> torch.Tensor:
        """This rank's remainder-epoch mixture ids after a world-size
        change (SPEC.md §6 over §8), positions built on the device and
        evaluated by the mixture kernels."""
        return mixture_elastic_indices_cuda(
            self.spec, self.seed, epoch, self.rank, self.world, layers,
            epoch_samples=self.epoch_samples, device=self.device,
            **self.kwargs,
        )
