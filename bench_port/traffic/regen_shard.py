"""Closed-loop shard-mode epoch regens of one rank (SPEC.md §7).

``PartialShuffleShardSampler(shards, num_replicas=world, rank=r,
window=w).device_epoch_indices(sizes, epoch=e)`` for e = 0, 1, 2, ...,
each to a synchronised stream: the rank's shard order and its expansion
to sample indices, a full shuffle within each shard.  A seed-drawn sample
of the window's regens is held, lane by lane, against the plain reference
of the shard order and of the expansion.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_port.counts import law as law_counts
from bench_port.reference import law
from bench_port.traffic import regen_plain


class Driver(regen_plain.Driver):
    def __init__(self, config: dict, params: dict, seed: int, device: str,
                 *, fault=None):
        super().__init__(dict(config, num_samples=config["num_shards"]),
                         params, seed, device, fault=fault)
        self.sizes = np.full(config["num_shards"], config["shard_size"],
                             dtype=np.int64)
        self.within = config["within_shard_shuffle"]

    def setup(self):
        from partiallyshuffledistributedsampler_tpu_torch import (
            PartialShuffleShardSampler,
        )

        sampler = PartialShuffleShardSampler(
            self.n, num_replicas=self.world, rank=self.rank,
            window=self.window_len, seed=self.seed, rounds=self.rounds,
            partition=self.partition,
            backend="cuda" if self.device != "cpu" else "cpu")
        self.hold_state()

        def fn(e):
            return sampler.device_epoch_indices(
                self.sizes, epoch=e, within_shard_shuffle=self.within)

        self.fn = fn
        for e in regen_plain.WARM_EPOCHS:
            self.regen(e)
            self.sync()

    def reference(self, epoch: int, device, rounds=None) -> torch.Tensor:
        rounds = rounds or self.rounds
        sids = law.epoch_indices(self.n, self.window_len, self.seed, epoch,
                                 self.rank, self.world, rounds=rounds,
                                 partition=self.partition, device=device)
        return law.expand_shards(sids, torch.from_numpy(self.sizes).to(device),
                                 self.seed, epoch,
                                 within_shard_shuffle=self.within,
                                 rounds=rounds)

    def counts(self) -> dict:
        sids = law.epoch_indices(self.n, self.window_len, self.seed, 0,
                                 self.rank, self.world, rounds=self.rounds,
                                 partition=self.partition)
        shard = law_counts.shard_expansion(self.sizes[sids.numpy()],
                                           self.within, self.rounds)
        ids = law_counts.index_amortized(self.n, self.window_len, self.world,
                                         self.rank, self.rounds)
        return {"shard_kernels": shard, "index_amortized": ids,
                "regen": (shard[0] + ids[0], shard[1] + ids[1])}
