"""Device-resident epoch iteration: indices never leave the GPU.

The sampler streams indices to the host because torch Datasets live
there.  A pipeline whose data already sits on the card does not need
that: the epoch index tensor stays on the device and each step's batch
is a view of it, gathered inside the train step.  This module packages
that pattern, with next-epoch prefetch.
"""

from __future__ import annotations

from typing import Iterator

import torch

from ..ops import core, ensure_index_backend
from ..ops.cuda import elastic_indices_cuda, epoch_indices_cuda


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
