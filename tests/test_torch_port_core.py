"""The PyTorch port's law core against the JAX package's numpy reference.

Tolerance 0 throughout: the law is integer-exact, so every index must be
bit-identical to ``partiallyshuffledistributedsampler_tpu.ops.cpu``.
"""

import numpy as np
import pytest
import torch

from partiallyshuffledistributedsampler_tpu.ops import core as jcore
from partiallyshuffledistributedsampler_tpu.ops import cpu as jcpu
from partiallyshuffledistributedsampler_tpu_torch.ops import core, cpu

M32 = 0xFFFFFFFF

#: the parity grid of tests/test_pallas.py, plus wider and degenerate shapes
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
    dict(n=900, window=1024, world=2),           # window > n: all tail
    dict(n=1, window=1, world=1),
    dict(n=3001, window=1, world=5),             # W == 1: identity inner map
    dict(n=10_007, window=97, world=7, rounds=5),
]


def _cfg_id(c):
    return "-".join(f"{k}{v}" for k, v in c.items())


def test_int64_product_keeps_low_32_bits():
    """Lanes are int64; a product of two uint32 values overflows int64 and
    wraps modulo 2^64, which must leave the low 32 bits exact."""
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**32, size=4096, dtype=np.uint64)
    b = rng.integers(0, 2**32, size=4096, dtype=np.uint64)
    a[:3] = [M32, M32, 0x80000000]
    b[:3] = [0x85EBCA6B, M32, 0x80000000]
    got = (torch.from_numpy(a.astype(np.int64))
           * torch.from_numpy(b.astype(np.int64))) & M32
    want = [(int(x) * int(y)) & M32 for x, y in zip(a, b)]
    assert got.tolist() == want
    assert (M32 * 0x85EBCA6B) & M32 == int(
        (torch.tensor([M32]) * 0x85EBCA6B)[0] & M32
    )


def test_mix32_and_keys_match_reference():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 2**32, size=10_000, dtype=np.uint64).astype(np.uint32)
    got = core.mix32(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), jcore.mix32(np, x))
    for seed, epoch in [(0, 0), (42, 3), ((1 << 40) + 7, 1), (-5, 2**33 + 1)]:
        ek = core.derive_epoch_key(seed, epoch)
        assert isinstance(ek, int)
        assert ek == int(jcore.derive_epoch_key(np, seed, epoch))
        for fn in ("outer_key", "tail_key", "inner_pair_key"):
            assert getattr(core, fn)(ek) == int(
                getattr(jcore, fn)(np, np.uint32(ek))
            )


@pytest.mark.parametrize("m", [1, 2, 3, 7, 64, 1000, 8192, 122_070])
def test_swap_or_not_matches_reference_and_is_a_bijection(m):
    rng = np.random.default_rng(m)
    key = int(rng.integers(0, 2**32))
    x = np.arange(min(m, 20_000), dtype=np.uint32)
    want = jcore.swap_or_not(np, x, m, np.uint32(key), 24)
    got = core.swap_or_not(torch.from_numpy(x.astype(np.int64)), m, key, 24)
    np.testing.assert_array_equal(got.numpy(), want)
    if m <= 20_000:
        assert sorted(got.tolist()) == list(range(m))


@pytest.mark.parametrize("cfg", CONFIGS, ids=_cfg_id)
def test_epoch_indices_bit_identical(cfg):
    cfg = dict(cfg)
    n, w, world = cfg.pop("n"), cfg.pop("window"), cfg.pop("world")
    rng = np.random.default_rng(n)
    seed = int(rng.integers(0, 2**63))
    for rank in sorted({0, world - 1}):
        for epoch in (0, 3):
            want = jcpu.epoch_indices_np(n, w, seed, epoch, rank, world, **cfg)
            got = cpu.epoch_indices_cpu(n, w, seed, epoch, rank, world, **cfg)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)


def test_frozen_goldens():
    """The spec freeze of tests/test_permutation.py, through the port."""
    got = cpu.epoch_indices_cpu(1000, 64, 42, 3, 1, 4)[:8].tolist()
    assert got == [706, 727, 713, 733, 717, 766, 744, 716]
    got = cpu.epoch_indices_cpu(500, 32, (1 << 40) + 7, 1, 0, 1)[:8].tolist()
    assert got == [91, 90, 77, 69, 83, 67, 95, 79]


@pytest.mark.parametrize("n,window", [(1_000_000, 1000), (12_345, 512),
                                      (3 * 2**31 + 17, 8192)])
def test_stream_indices_at_bit_identical(n, window):
    """Random access, including uint64 positions (n >= 2^31) and positions
    past 2^32 that wrap in the uint32 regime."""
    rng = np.random.default_rng(7)
    pos = rng.integers(0, 2**34, size=5000, dtype=np.int64)
    pos[:3] = [0, n - 1, 2**32 + 3]
    want = jcpu.stream_indices_at_np(pos, n, window, 9, 2)
    got = cpu.stream_indices_at_cpu(torch.from_numpy(pos), n, window, 9, 2)
    assert str(got.dtype).split(".")[-1] == want.dtype.name
    np.testing.assert_array_equal(got.numpy(), want)
    unshuffled = cpu.stream_indices_at_cpu(pos, n, window, 9, 2, shuffle=False)
    np.testing.assert_array_equal(
        unshuffled.numpy(),
        jcpu.stream_indices_at_np(pos, n, window, 9, 2, shuffle=False),
    )


@pytest.mark.parametrize("world", [1, 3, 8])
def test_full_epoch_stream_bit_identical(world):
    want = jcpu.full_epoch_stream_np(7001, 128, 11, 4, world=world)
    got = cpu.full_epoch_stream_cpu(7001, 128, 11, 4, world=world)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("layers,partition,world,drop_last", [
    ([(4, 10)], "strided", 3, False),
    ([(4, 10), (3, 5)], "blocked", 3, False),
    ([(8, 0)], "strided", 5, False),
    ([(2, 400), (5, 17)], "strided", 2, True),
    ([(4, 250)], "blocked", 2, False),            # fully consumed: empty
])
def test_elastic_indices_bit_identical(layers, partition, world, drop_last):
    for rank in range(world):
        want = jcpu.elastic_indices_np(1000, 64, 5, 1, rank, world, layers,
                                       partition=partition,
                                       drop_last=drop_last)
        got = cpu.elastic_indices_cpu(1000, 64, 5, 1, rank, world, layers,
                                      partition=partition,
                                      drop_last=drop_last)
        assert got.dtype == torch.int32 and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
    assert core.elastic_chain(1000, layers, world, drop_last) == \
        jcore.elastic_chain(1000, layers, world, drop_last)


def test_epoch_indices_wide_index_space():
    """n >= 2^31: positions are uint64 and indices int64 — the generic law
    on a short slice of a rank's stream at the 10B-sample shape."""
    n, w, world = 10_000_000_000, 8192, 4096
    pos = torch.arange(3, 3 + world * 2000, world, dtype=torch.int64)
    want = jcpu.stream_indices_at_np(pos.numpy(), n, w, 1, 0)
    got = cpu.stream_indices_at_cpu(pos, n, w, 1, 0)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_argument_checks():
    with pytest.raises(ValueError):
        core.shard_sizes(0, 1, False)
    with pytest.raises(ValueError):
        core.shard_sizes(10, 0, False)
    with pytest.raises(ValueError):
        core.shard_sizes(3, 8, True)
    with pytest.raises(ValueError, match="window"):
        cpu.epoch_indices_cpu(100, 0, 0, 0, 0, 1)
    with pytest.raises(ValueError, match="rank"):
        cpu.epoch_indices_cpu(100, 10, 0, 0, 4, 4)
    with pytest.raises(ValueError, match="partition"):
        cpu.epoch_indices_cpu(100, 10, 0, 0, 0, 2, partition="diagonal")
    with pytest.raises(ValueError, match="uint32 range"):
        core.fold_seed((2**32, 0))
    with pytest.raises(ValueError, match="length"):
        core.fold_seed((1, 2, 3))
    with pytest.raises(ValueError, match="empty"):
        core.elastic_chain(100, [], 2)
    assert core.fold_seed((1 << 40) + 7) == jcore.fold_seed((1 << 40) + 7)
