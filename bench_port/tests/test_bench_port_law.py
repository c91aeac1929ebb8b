"""The benchmark's plain reference of the law against the port's CPU route,
at small sizes (the port's CPU route is its kernels' plain version)."""

import numpy as np
import pytest
import torch

from bench_port.reference import law

import partiallyshuffledistributedsampler_tpu_torch as pt
from partiallyshuffledistributedsampler_tpu_torch.sampler.shard_mode import (
    expand_shard_indices_cpu,
)


@pytest.mark.parametrize("n,window,seed,epoch,rank,world,partition,rounds", [
    (100_000, 64, 5, 3, 2, 8, "strided", 24),
    (1_000_003, 8192, 2**31 + 77, 1, 5, 256, "strided", 24),
    (50, 64, 9, 0, 0, 1, "strided", 24),
    (12_345, 100, 2**40 + 3, 7, 3, 4, "blocked", 24),
    (9_999, 128, 11, 2**32 - 1, 1, 3, "strided", 16),
])
def test_epoch_indices_match_the_port(n, window, seed, epoch, rank, world,
                                      partition, rounds):
    got = law.epoch_indices(n, window, seed, epoch, rank, world,
                            rounds=rounds, partition=partition)
    want = pt.epoch_indices_cuda(n, window, seed, epoch, rank, world,
                                 rounds=rounds, partition=partition,
                                 device="cpu").long()
    assert torch.equal(got, want)


@pytest.mark.parametrize("within", [True, 64, 2, False])
@pytest.mark.parametrize("seed", [5, 2**33 + 11])
def test_shard_expansion_matches_the_port(within, seed):
    sizes = np.full(200, 1000)
    sizes[[3, 5, 7]] = [0, 7, 1]
    sids = np.array([5, 3, 7, 10, 150, 0, 199])
    got = law.expand_shards(torch.as_tensor(sids), torch.as_tensor(sizes),
                            seed, 4, within_shard_shuffle=within)
    want = np.asarray(expand_shard_indices_cpu(
        sids, sizes, seed=seed, epoch=4, within_shard_shuffle=within))
    assert torch.equal(got, torch.as_tensor(want).long())


def test_fewer_rounds_change_the_stream():
    """The regen cells' control (16 rounds for 24) differs on most lanes."""
    a = law.epoch_indices(1_000_003, 8192, 3, 0, 1, 256)
    b = law.epoch_indices(1_000_003, 8192, 3, 0, 1, 256, rounds=16)
    assert (a != b).float().mean() > 0.9
