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


TEN_B = 10_000_000_000
N31 = 2**31 + 5000
#: (n, window, world, rank, law kwargs) of the wide kernels (n >= 2^31)
WIDE_CASES = [
    (N31, 8192, 8192, 4999, {}),                  # m = 1, one tail lane
    (N31, 8192, 4096, 4095, {}),                  # m = 2
    (TEN_B, 8192, 8192, 0, {}),
    (TEN_B, 8192, 8192, 8191, {"partition": "blocked"}),
    (TEN_B, 8192, 8192, 5, {"drop_last": True}),
    (TEN_B, 8192, 8192, 3, {"order_windows": False}),
]


@pytest.mark.parametrize("n,window,world,rank,kw", WIDE_CASES)
def test_wide_kernels_match_numpy_reference(n, window, world, rank, kw):
    ck.reset_launches()
    want = jcpu.epoch_indices_np(n, window, 42, 3, rank, world, **kw)
    for amortize in (True, False):
        got = cuda.epoch_indices_cuda(n, window, 42, 3, rank, world,
                                      amortize=amortize, **kw)
        assert got.is_cuda and got.dtype == torch.int64
        np.testing.assert_array_equal(got.cpu().numpy(), want)
    amortized = kw.get("partition") != "blocked"
    assert ck.launches["index_amortized_wide"] == int(amortized)
    assert ck.launches["index_general_wide"] == 2 - int(amortized)
    assert ck.launches["index_general"] == ck.launches["index_amortized"] == 0


def test_wide_kernels_match_plain_versions_at_world_256():
    """The config-5 shard, 39,062,500 lanes, on every lane."""
    ns, _ = core.shard_sizes(TEN_B, 256, False)
    ku = ck.window_order_ids(TEN_B, 8192, 0, 1)
    want = ck.index_amortized_wide_ref(ku, TEN_B, 8192, 0, 1, 255, 256, ns)
    assert torch.equal(ck.index_amortized_wide(ku, TEN_B, 8192, 0, 1, 255,
                                               256), want)
    assert torch.equal(ck.index_general_wide(TEN_B, 8192, 0, 1, 255, 256),
                       want)
    assert int(want.max()) > 2**31


def _triple(seed, epoch):
    bits = np.array(core.seed_triple(seed, epoch), dtype=np.uint32)
    return torch.from_numpy(bits.view(np.int32)).cuda()


@pytest.mark.parametrize("n,window,world", [(50_000, 512, 4),
                                            (TEN_B, 8192, 8192)])
def test_device_triple_matches_scalar_launches(n, window, world):
    seed, epoch = (1 << 40) + 0xFFFFFFF7, 0xFFFFFFF0
    t = _triple(seed, epoch)
    wide = core.is_wide(n)
    general = ck.index_general_wide if wide else ck.index_general
    amortized = ck.index_amortized_wide if wide else ck.index_amortized
    ku = ck.window_order_ids(n, window, seed, epoch)
    ku_t = ck.window_order_ids(n, window, None, None, triple=t)
    assert torch.equal(ku, ku_t)
    for rank in (0, world - 1):
        want = general(n, window, seed, epoch, rank, world)
        assert torch.equal(general(n, window, None, None, rank, world,
                                   triple=t), want)
        assert torch.equal(amortized(ku_t, n, window, None, None, rank,
                                     world, triple=t), want)
        assert torch.equal(cuda.epoch_indices_cuda(
            n, window, None, None, rank, world, triple=t), want)
    with pytest.raises(ValueError, match="triple"):
        general(n, window, seed, epoch, 0, world, triple=t)
    with pytest.raises(ValueError, match="int32"):
        general(n, window, None, None, 0, world, triple=t.long())


def test_num_samples_past_2_32_lanes_spot_checks():
    """The general wide kernel with a 64-bit lane counter: n = 2^32 + 4097
    at world 1 (34.4 GB of int64)."""
    n = 2**32 + 4097
    out = cuda.epoch_indices_cuda(n, 8192, 0, 1, 0, 1)
    lanes = torch.tensor([0, 2**32 - 2, 2**32 - 1, 2**32, 2**32 + 1,
                          2**32 + 2, n - 1], device="cuda")
    want = cuda.stream_indices_at_cuda(lanes, n, 8192, 0, 1)
    assert torch.equal(out[lanes], want)
    del out
    torch.cuda.empty_cache()
