"""The shard sampler's regen on the card launches with the size tables it
remembered and confirms them after its launches (marker ``cuda``; skips on
a machine without an NVIDIA GPU, since a CUDA kernel has no interpret
mode).  Sizes changed in place between two regens make the second a miss:
it launches again with the confirmed tables, returns that output, exact
against the host reference, and drops the first.

Run on a GPU machine with
``python -m pytest -m cuda tests/test_torch_port_gpu_shard_speculative.py``.
"""

import numpy as np
import pytest
import torch

from partiallyshuffledistributedsampler_tpu_torch import (
    PartialShuffleShardSampler,
)
from partiallyshuffledistributedsampler_tpu_torch.ops import shard as S
from partiallyshuffledistributedsampler_tpu_torch.sampler import shard_mode

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def gpu(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no interpret mode)")
    monkeypatch.setattr(S, "_confirmed", {})
    S.reset_table_checks()


def test_a_regen_after_an_in_place_change_returns_the_confirmed_answer(
        monkeypatch):
    num_shards, seed, epoch, wss = 2000, 9, 3, 64
    sampler = PartialShuffleShardSampler(num_shards, num_replicas=8, rank=5,
                                         seed=seed, backend="cuda")
    sizes = np.full(num_shards, 1000, dtype=np.int64)
    outs = []
    expand = shard_mode._expand

    def recorded(*args, **kw):
        outs.append(expand(*args, **kw))
        return outs[-1]

    monkeypatch.setattr(shard_mode, "_expand", recorded)
    ids = torch.as_tensor(sampler._shard_ids(epoch)).cpu().numpy()

    def want():
        return shard_mode.expand_shard_indices_cpu(
            ids, sizes, seed=seed, epoch=epoch, within_shard_shuffle=wss)

    first = sampler.device_epoch_indices(sizes, epoch=epoch,
                                         within_shard_shuffle=wss)
    np.testing.assert_array_equal(first.cpu().numpy(), want().numpy())
    # the same length and sum, other sizes of two of the rank's shards
    sizes[ids[0]], sizes[ids[1]] = 999, 1001
    outs.clear()
    got = sampler.device_epoch_indices(sizes, epoch=epoch,
                                       within_shard_shuffle=wss)
    assert got.is_cuda
    np.testing.assert_array_equal(got.cpu().numpy(), want().numpy())
    assert S.table_checks == {"hits": 0, "misses": 1}
    # two launches: the remembered tables' output, dropped, then the
    # confirmed one's, returned
    dropped, kept = outs
    assert kept is got and dropped is not got
    dropped_before = dropped.clone()
    assert not torch.equal(dropped_before, got)
    got.fill_(-1)
    assert torch.equal(dropped, dropped_before)
    # the next regen with the same sizes is a hit: one launch
    outs.clear()
    again = sampler.device_epoch_indices(sizes, epoch=epoch,
                                         within_shard_shuffle=wss)
    np.testing.assert_array_equal(again.cpu().numpy(), want().numpy())
    assert len(outs) == 1 and S.table_checks == {"hits": 1, "misses": 1}
