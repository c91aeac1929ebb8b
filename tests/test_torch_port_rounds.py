"""Round counts above 64 and the host-side magic numbers of the port.

The kernels take 0 to ``MAX_ROUNDS`` swap-or-not rounds (SPEC.md §2 cites
~102 and ~121 for the production domains).  Here, on the CPU, each kernel
family's plain PyTorch version is held against the JAX package's numpy
reference at rounds 65, 102 and 121 (tolerance 0: the law is
integer-exact), the limit is checked to be one number on the C and the
Python side, and ``ops/fastdiv.py``'s magic numbers are held against floor
division.  The kernels themselves are held at these round counts on the
card by ``tests/test_torch_port_gpu.py``.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from partiallyshuffledistributedsampler_tpu import (
    PartiallyShuffleDistributedSampler as JaxSampler,
)
from partiallyshuffledistributedsampler_tpu.ops import cpu as jcpu
from partiallyshuffledistributedsampler_tpu.ops import mixture as jmix
from partiallyshuffledistributedsampler_tpu.sampler import shard_mode as jshard
from partiallyshuffledistributedsampler_tpu_torch import (
    MixtureSpec,
    PartiallyShuffleDistributedSampler as TorchSampler,
    mixture_epoch_indices_cpu,
    mixture_stream_at_cpu,
)
from partiallyshuffledistributedsampler_tpu_torch.ops import (
    core,
    cuda,
    cuda_kernel as ck,
    fastdiv,
    mixture as pmix,
)
from partiallyshuffledistributedsampler_tpu_torch.sampler import shard_mode

CSRC = (pathlib.Path(__file__).resolve().parents[1]
        / "partiallyshuffledistributedsampler_tpu_torch" / "csrc")
HIGH_ROUNDS = (65, 102, 121)
#: the JAX sampler's checkpoint at rounds=102 (n 100,000, window 8192,
#: world 8, seed 11, epoch 2, 1,000 samples consumed); the card test
#: ``test_jax_checkpoint_at_rounds_102_regenerates_on_the_card`` loads the
#: same dict
JAX_CKPT_R102 = {
    "spec_version": 2, "kind": "single", "seed": 11, "epoch": 2,
    "offset": 1000, "n": 100000, "num_replicas": 8, "window": 8192,
    "rounds": 102, "order_windows": True, "partition": "strided",
    "shuffle": True, "drop_last": False,
}


# ------------------------------------------------------------ magic numbers
#: divisors per case: small, powers of two and their neighbours, the
#: shard and window sizes of the repo's shapes, primes, the largest
DIVISOR_CASES = {
    "1-64": list(range(1, 65)),
    "pow2": [1 << k for k in range(1, 31)],
    "pow2-1": [(1 << k) - 1 for k in range(2, 31)],
    "pow2+1": [(1 << k) + 1 for k in range(1, 31)],
    "shard-sizes": [200, 600, 1000, 2000, 10_000, 50_000, 100_000],
    "windows": [7, 50, 64, 97, 128, 512, 4096, 8192, 16384, 32768],
    "primes": [641, 6700417, 2147483647, 4294967291],
    "top": [2**31, 2**31 + 1, 2**32 - 2, 2**32 - 1],
}


def _edge_numerators(d: int, bits: int) -> list:
    top = (1 << bits) - 1
    last = top // d * d  # the largest multiple of d
    rng = np.random.default_rng(d % 1000)
    rand = [int(v) for v in rng.integers(0, 1 << 62, 16)]
    cand = [0, 1, d - 1, d, d + 1, 2 * d - 1, 2 * d, last - 1, last,
            last - d, top, top - 1] + [v % (top + 1) for v in rand]
    return sorted({v for v in cand if 0 <= v <= top})


@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("case", sorted(DIVISOR_CASES))
def test_magic_division_matches_floor_division(case, bits):
    divisors = DIVISOR_CASES[case]
    if bits == 64:  # the 64-bit form also takes divisors past 2^32
        divisors = divisors + [d * (1 << 32) + 3 for d in divisors[:8]]
    for d in divisors:
        m = fastdiv.magic(d, bits)
        assert 0 < m[0] < 1 << bits and m[1] in (0, 1) and m[2] < bits
        for n in _edge_numerators(d, bits):
            assert fastdiv.divide(n, m, bits) == n // d, (d, n)


def test_magic_refuses_what_it_cannot_divide():
    with pytest.raises(ValueError, match="divisor"):
        fastdiv.magic(0)
    with pytest.raises(ValueError, match="divisor"):
        fastdiv.magic(2**32)
    with pytest.raises(ValueError, match="bits"):
        fastdiv.magic(3, 16)
    assert fastdiv.magic(2**32, 64)[0] == 1  # a power of two: a shift


# ------------------------------------------------------------ the limit
def _c_constant(source: str, name: str) -> int:
    text = (CSRC / source).read_text()
    return int(re.search(rf"constexpr \w+ {name} = (\d+);", text).group(1))


def test_round_limit_and_stage_cap_are_one_number_on_each_side():
    assert _c_constant("law.cuh", "MAX_ROUNDS") == ck.MAX_ROUNDS == 4096
    assert (_c_constant("mixture_kernels.cu", "STAGE_WORDS_CAP")
            == ck.STAGE_WORDS_CAP)
    assert ck.FOLD_WORDS_CAP <= ck.STAGE_WORDS_CAP


@pytest.mark.parametrize("rounds,ok", [(0, True), (121, True),
                                       (4096, True), (4097, False),
                                       (-1, False)])
def test_kernel_arguments_take_rounds_up_to_the_limit(rounds, ok):
    if ok:
        ck._check_kernel_args(100_000, 8192, 8, rounds, False)
    else:
        with pytest.raises(ValueError, match="rounds must be in \\[0, 4096\\]"):
            ck._check_kernel_args(100_000, 8192, 8, rounds, False)


# ------------------------------------------------------------ index law
@pytest.mark.parametrize("partition", ["strided", "blocked"])
@pytest.mark.parametrize("rounds", HIGH_ROUNDS)
def test_epoch_indices_at_high_rounds_match_numpy(rounds, partition):
    """n = 1000, window 64: 15 windows and a tail window of 40."""
    n, w, world = 1000, 64, 4
    for rank in (0, 3):
        want = jcpu.epoch_indices_np(n, w, 9, 2, rank, world,
                                     partition=partition, rounds=rounds)
        got = cuda.epoch_indices_cuda(n, w, 9, 2, rank, world,
                                      partition=partition, rounds=rounds,
                                      device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)
        got = ck.index_general(n, w, 9, 2, rank, world, partition=partition,
                               rounds=rounds, device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)
        if partition == "strided":
            got = ck.index_amortized(n, w, 9, 2, rank, world, rounds=rounds,
                                     device="cpu")
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rounds", HIGH_ROUNDS)
def test_stream_indices_at_high_rounds_match_numpy(rounds):
    pos = np.random.default_rng(rounds).integers(0, 5000, 3000)
    for n, w in ((1000, 64), (12_345, 512)):
        want = jcpu.stream_indices_at_np(pos, n, w, 3, 7, rounds=rounds)
        got = cuda.stream_indices_at_cuda(pos, n, w, 3, 7, rounds=rounds,
                                          device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ mixture
SIZES, WEIGHTS = [1000, 500, 2500], [5, 1, 4]


@pytest.mark.parametrize("pattern_version", [1, 2])
@pytest.mark.parametrize("rounds", HIGH_ROUNDS)
def test_mixture_at_high_rounds_matches_numpy(rounds, pattern_version):
    kw = dict(windows=64, block=100, pattern_version=pattern_version)
    js, ps = jmix.MixtureSpec(SIZES, WEIGHTS, **kw), MixtureSpec(SIZES,
                                                                 WEIGHTS,
                                                                 **kw)
    world, rank = 3, 1
    want = jmix.mixture_epoch_indices_np(js, 42, 3, rank, world,
                                         rounds=rounds)
    got = mixture_epoch_indices_cpu(ps, 42, 3, rank, world, rounds=rounds)
    np.testing.assert_array_equal(got.numpy(), want)
    # the kernels' plain versions: keys folded (None) and keys given
    _t, ns, total = pmix.mixture_epoch_sizes(ps, None, world, False)
    lanes = dict(rank=rank, world=world, num_samples=ns,
                 wide_pos=total + ps.block > core.INT32_MAX, rounds=rounds)
    folded = ck.mixture_fused(None, ps, 42, 3, device="cpu", **lanes)
    keys = ck.mixture_source_keys(ps, 42, 3, rounds=rounds, device="cpu")
    assert keys.numel() == ck.mixture_key_words(ps, rounds)
    given = ck.mixture_fused(keys, ps, 42, 3, **lanes)
    np.testing.assert_array_equal(folded.numpy(), want)
    np.testing.assert_array_equal(given.numpy(), want)
    pos = np.random.default_rng(rounds).integers(0, 10**6, 2000)
    np.testing.assert_array_equal(
        mixture_stream_at_cpu(pos, ps, 5, 1, rounds=rounds).numpy(),
        jmix.mixture_stream_at_np(pos, js, 5, 1, rounds=rounds))


@pytest.mark.parametrize("sources,rounds,folds", [
    ((700, 200, 100), 24, True),       # M1's shape: 221 + 24 words
    ((175,) * 4 + (200, 100), 24, True),  # M3's six sources: 488 words
    ((5,) * 7, 24, True),              # 569 words: the most that fold
    ((5,) * 8, 24, False),
    ((5,) * 300, 24, False),           # the 300-source spec
    ((700, 200, 100), 40, True),       # 2 + 3 * 129 words
    ((700, 200, 100), 121, False),     # 2 + 3 * 372 words
])
def test_mixture_folds_while_the_staged_words_are_few(sources, rounds, folds):
    spec = MixtureSpec([s * 1000 for s in sources], [1] * len(sources),
                       windows=64, block=4096)
    words = ck.mixture_key_words(spec, rounds) + 8 * spec.num_sources
    assert ck.mixture_folds(spec, rounds) == folds
    assert folds == (words <= ck.FOLD_WORDS_CAP)


# ------------------------------------------------------------ shards
#: sizes with a zero-size shard, sizes below and above the windows, and an
#: id stream that selects them all
SHARD_SIZES = [37, 0, 64, 5, 130, 1, 2, 71, 0, 500]
SHARD_IDS = [9, 1, 4, 0, 8, 2, 7, 3, 6, 5]


@pytest.mark.parametrize("mode", [True, 16, 1, False])
@pytest.mark.parametrize("rounds", HIGH_ROUNDS)
def test_shard_expansion_at_high_rounds_matches_numpy(rounds, mode):
    want = jshard.expand_shard_indices_np(
        SHARD_IDS, SHARD_SIZES, seed=7, epoch=4, within_shard_shuffle=mode,
        rounds=rounds)
    for fn in (shard_mode.expand_shard_indices_generic,
               shard_mode.expand_shard_indices_cpu):
        got = fn(SHARD_IDS, SHARD_SIZES, seed=7, epoch=4,
                 within_shard_shuffle=mode, rounds=rounds)
        np.testing.assert_array_equal(got.numpy(), want)
    got = shard_mode.expand_shard_indices_cuda(
        torch.tensor(SHARD_IDS), SHARD_SIZES, seed=7, epoch=4,
        within_shard_shuffle=mode, rounds=rounds, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ checkpoint
def test_jax_checkpoint_at_rounds_102_loads_into_the_port():
    js = JaxSampler(100_000, num_replicas=8, rank=3, window=8192, rounds=102,
                    seed=11, backend="cpu")
    js.set_epoch(2)
    it = iter(js)
    head = [next(it) for _ in range(1000)]
    assert js.state_dict() == JAX_CKPT_R102
    want = jcpu.epoch_indices_np(100_000, 8192, 11, 2, 3, 8, rounds=102)
    # a sampler built with the checkpoint's config resumes it
    ts = TorchSampler(100_000, 8, 3, window=8192, seed=11, rounds=102,
                      backend="cpu")
    ts.load_state_dict(JAX_CKPT_R102)
    assert head + list(ts) == want.tolist()
    ts.set_epoch(3)
    assert list(ts) == jcpu.epoch_indices_np(100_000, 8192, 11, 3, 3, 8,
                                             rounds=102).tolist()
    # a reshard from it takes the round count from the checkpoint
    for world, rank in ((8, 3), (5, 4)):
        got = TorchSampler.reshard_from_state_dict(JAX_CKPT_R102, world,
                                                   rank, backend="cpu")
        ref = JaxSampler.reshard_from_state_dict(JAX_CKPT_R102, world, rank,
                                                 backend="cpu")
        assert got.rounds == 102 and list(got) == list(ref)
