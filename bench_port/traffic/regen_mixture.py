"""Closed-loop mixture epoch regens of one rank (SPEC.md §8).

``mixture_epoch_indices_cuda(spec, seed, e, rank, world)`` for e = 0, 1, 2,
..., each to a synchronised stream, over the configuration's ``mixture``
(sources, integer weights, windows, block): the rank's share of the
mixture epoch, one ``mixture_fused`` a regen with the sources' keys
derived in the kernel.  The rank's training state of the configuration's
model lies on the card beside the loop.  A seed-drawn sample of the
window's regens is held, lane by lane, against the plain reference of the
§8 law (``reference/mixture_law.py``).
"""

from __future__ import annotations

import torch

from bench_port import kinds
from bench_port.counts import mixture as mixture_counts
from bench_port.reference import mixture_law
from bench_port.traffic import regen_plain


class Driver(regen_plain.Driver):
    def __init__(self, config: dict, params: dict, seed: int, device: str,
                 *, fault=None):
        mix = config["mixture"]
        model = kinds.load(config["model"]["kind"]).model_of(config)
        super().__init__(dict(num_samples=sum(mix["sources"]),
                              window=mix["windows"], rounds=mix["rounds"],
                              partition=mix["partition"], model=model),
                         params, seed, device, fault=fault)
        self.law = (mix["sources"], mix["weights"], mix["windows"],
                    mix["block"])

    def setup(self):
        from partiallyshuffledistributedsampler_tpu_torch import MixtureSpec
        from partiallyshuffledistributedsampler_tpu_torch.ops.mixture import (
            mixture_epoch_indices_cuda,
        )

        sources, weights, windows, block = self.law
        spec = MixtureSpec(sources, weights, windows=windows, block=block)
        self.hold_state()

        def fn(e):
            return mixture_epoch_indices_cuda(
                spec, self.seed, e, self.rank, self.world, rounds=self.rounds,
                partition=self.partition, device=self.device)

        self.fn = fn
        for e in regen_plain.WARM_EPOCHS:
            self.regen(e)
            self.sync()

    def reference(self, epoch: int, device, rounds=None) -> torch.Tensor:
        return mixture_law.epoch_indices(
            *self.law, self.seed, epoch, self.rank, self.world,
            rounds=rounds or self.rounds, partition=self.partition,
            device=device)

    def counts(self) -> dict:
        """The law's work of one regen (epoch 0's lanes in full windows
        and in tail windows): ``mixture_fused``'s and the whole regen's."""
        sources, weights, windows, block = self.law
        body, tail = mixture_counts.rank_lanes(
            sources, weights, windows, block, self.seed, 0, self.rank,
            self.world, self.partition, device=self.device)
        work = mixture_counts.mixture_fused(body, tail, len(sources), block,
                                            self.rounds)
        return {"mixture_fused": work, "regen": work}
