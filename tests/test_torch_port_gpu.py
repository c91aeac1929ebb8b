"""The port's CUDA kernels on the card (marker ``cuda``; they skip on a
machine without an NVIDIA GPU, since a CUDA kernel has no interpret mode).

Run on a GPU machine with ``python -m pytest -m cuda tests/test_torch_port_gpu.py``.
This file imports no jax: it holds the kernels bit-exact (tolerance 0)
against the JAX package's numpy reference, which needs numpy only, and
against the port's plain versions on the same inputs.
"""

import numpy as np
import pytest
import torch

from partiallyshuffledistributedsampler_tpu.ops import cpu as jcpu
from partiallyshuffledistributedsampler_tpu_torch import (
    DeviceEpochIterator,
    PartiallyShuffleDistributedSampler,
)
from partiallyshuffledistributedsampler_tpu_torch.ops import (
    core,
    cuda,
    cuda_kernel as ck,
)

pytestmark = pytest.mark.cuda

CONFIGS = [
    dict(n=5000, window=512, world=2),
    dict(n=1024, window=64, world=8),
    dict(n=12_345, window=512, world=8),
    dict(n=100, window=7, world=3),
    dict(n=4096, window=4096, world=4),
    dict(n=2000, window=128, world=4, partition="blocked"),
    dict(n=2000, window=128, world=4, order_windows=False),
    dict(n=999, window=50, world=2, shuffle=False),
    dict(n=640, window=64, world=8, drop_last=True),
    dict(n=900, window=1024, world=2),
    dict(n=3001, window=1, world=5),
    dict(n=10_007, window=97, world=7, rounds=5),
]
AMORTIZED_SHAPES = [(4096, 256, 8), (8200, 128, 8), (4096, 256, 2),
                    (4100, 512, 2), (70_000, 32768, 2), (50_000, 16384, 2),
                    (1000, 64, 64)]


def _cfg_id(c):
    return "-".join(f"{k}{v}" for k, v in c.items())


@pytest.fixture(autouse=True)
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no interpret mode)")


@pytest.mark.parametrize("cfg", CONFIGS, ids=_cfg_id)
def test_entry_bit_identical_on_gpu(cfg):
    cfg = dict(cfg)
    n, w, world = cfg.pop("n"), cfg.pop("window"), cfg.pop("world")
    for rank in (0, world - 1):
        want = jcpu.epoch_indices_np(n, w, 42, 3, rank, world, **cfg)
        for amortize in (True, False):
            got = cuda.epoch_indices_cuda(n, w, 42, 3, rank, world,
                                          amortize=amortize, **cfg)
            assert got.is_cuda and got.dtype == torch.int32
            np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.parametrize("n,window,world", AMORTIZED_SHAPES)
def test_amortized_kernels_match_plain_versions(n, window, world):
    ck.reset_launches()
    ns, _ = core.shard_sizes(n, world, False)
    for rank in (0, world - 1):
        ku = ck.window_order_ids(n, window, 5, 9)
        assert torch.equal(ku.long(), ck.window_order_ids_ref(
            n, window, 5, 9, device="cuda"))
        got = ck.index_amortized(ku, n, window, 5, 9, rank, world)
        assert torch.equal(got, ck.index_amortized_ref(
            ku, n, window, 5, 9, rank, world, ns))
        np.testing.assert_array_equal(
            got.cpu().numpy(), jcpu.epoch_indices_np(n, window, 5, 9, rank,
                                                     world))
    assert ck.launches["window_order_ids"] == 2
    assert ck.launches["index_amortized"] == 2
    assert ck.launches["index_general"] == 0


def test_goldens_on_gpu():
    assert cuda.epoch_indices_cuda(1000, 64, 42, 3, 1, 4)[:8].tolist() == \
        [706, 727, 713, 733, 717, 766, 744, 716]
    assert cuda.epoch_indices_cuda(
        500, 32, (1 << 40) + 7, 1, 0, 1)[:8].tolist() == \
        [91, 90, 77, 69, 83, 67, 95, 79]


def test_wrappers_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="rounds"):
        ck.index_general(1000, 64, 0, 0, 0, 2, rounds=65, device="cuda")
    with pytest.raises(ValueError, match="window"):
        ck.index_general(1000, 2**32 + 5, 0, 0, 0, 2, device="cuda")
    with pytest.raises(ValueError, match="int32"):
        ck.index_amortized(torch.zeros(3, dtype=torch.int64, device="cuda"),
                           1000, 256, 0, 0, 0, 2)


def test_sampler_and_iterator_on_gpu():
    ck.reset_launches()
    s = PartiallyShuffleDistributedSampler(20_000, 4, 2, window=512)
    s.set_epoch(3)
    want = jcpu.epoch_indices_np(20_000, 512, 0, 3, 2, 4)
    assert list(s) == want.tolist()
    it = DeviceEpochIterator(20_000, 512, 100, rank=2, world=4)
    batches = list(it.epoch(3))
    assert all(b.is_cuda for b in batches)
    np.testing.assert_array_equal(torch.cat(batches).cpu().numpy(),
                                  want[:len(batches) * 100])
    assert ck.launches["index_amortized"] >= 2
