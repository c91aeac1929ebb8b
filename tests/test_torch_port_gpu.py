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
    shard as S,
)
from partiallyshuffledistributedsampler_tpu_torch.sampler import shard_mode

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
        got = ck.index_amortized(n, window, 5, 9, rank, world)
        assert torch.equal(got, ck.epoch_indices_amortized_ref(
            n, window, 5, 9, rank, world, ns, device="cuda"))
        np.testing.assert_array_equal(
            got.cpu().numpy(), jcpu.epoch_indices_np(n, window, 5, 9, rank,
                                                     world))
    # one launch per regen: the window order is computed in the kernel
    assert ck.launches["index_amortized"] == 2
    assert sum(ck.launches.values()) == 2


N31 = 2**31 + 5000
#: (n, window, world, law kwargs) at the fused amortized kernel's tile
#: edges: m = 1, m above TILE_MAX (one tile inside a slot), slots cut by
#: tile edges (m = 75; m = 3), the largest tile (10M lanes), one window,
#: no window order, drop_last, tail and wrap-padding lanes, 64 rounds, and
#: a wide shape
FUSED_CASES = [
    (200_000, 64, 64, {}),
    (100_000, 8192, 1, {}),
    (10_000_000, 8192, 1, {}),
    (1_000_003, 600, 8, {}),
    (3_000_001, 96, 32, {}),
    (10_000_000, 4096, 1024, {}),
    (5000, 4096, 4, {}),
    (500_000, 512, 8, dict(order_windows=False)),
    (500_003, 512, 8, dict(drop_last=True)),
    (500_003, 512, 8, dict(rounds=64)),
    (N31, 8192, 4096, {}),
]


@pytest.mark.parametrize("n,window,world,kw", FUSED_CASES)
def test_fused_amortized_kernel_at_tile_edges(n, window, world, kw):
    wide = core.is_wide(n)
    amortized = ck.index_amortized_wide if wide else ck.index_amortized
    general = ck.index_general_wide if wide else ck.index_general
    ns, _ = core.shard_sizes(n, world, kw.get("drop_last", False))
    plain_kw = {k: v for k, v in kw.items() if k != "drop_last"}
    for rank in sorted({0, world // 2, world - 1}):
        ck.reset_launches()
        got = amortized(n, window, 7, 2, rank, world, **kw)
        assert sum(ck.launches.values()) == 1
        assert got.dtype == core.out_dtype(n) and got.numel() == ns
        assert torch.equal(got, ck.epoch_indices_amortized_ref(
            n, window, 7, 2, rank, world, ns, device="cuda", **plain_kw))
        assert torch.equal(got, general(n, window, 7, 2, rank, world, **kw))
        if ns <= 200_000:
            np.testing.assert_array_equal(
                got.cpu().numpy(),
                jcpu.epoch_indices_np(n, window, 7, 2, rank, world, **kw))


def test_goldens_on_gpu():
    assert cuda.epoch_indices_cuda(1000, 64, 42, 3, 1, 4)[:8].tolist() == \
        [706, 727, 713, 733, 717, 766, 744, 716]
    assert cuda.epoch_indices_cuda(
        500, 32, (1 << 40) + 7, 1, 0, 1)[:8].tolist() == \
        [91, 90, 77, 69, 83, 67, 95, 79]


def test_wrappers_refuse_what_the_kernels_do_not_take():
    above = ck.MAX_ROUNDS + 1
    with pytest.raises(ValueError, match="rounds"):
        ck.index_general(1000, 64, 0, 0, 0, 2, rounds=above, device="cuda")
    with pytest.raises(ValueError, match="window"):
        ck.index_general(1000, 2**32 + 5, 0, 0, 0, 2, device="cuda")
    with pytest.raises(ValueError, match="rank"):
        ck.index_amortized(1000, 256, 0, 0, 2, 2)
    with pytest.raises(ValueError, match="rounds"):
        ck.index_amortized(1000, 256, 0, 0, 0, 2, rounds=above)
    spec = MixtureSpec(SIZES, WEIGHTS, windows=64, block=100)
    with pytest.raises(ValueError, match="rounds"):
        ck.mixture_source_keys(spec, 0, 0, rounds=above)
    with pytest.raises(ValueError, match="rounds"):
        mixture_epoch_indices_cuda(spec, 0, 0, 0, 1, rounds=above)
    with pytest.raises(ValueError, match="rounds"):
        shard_mode.expand_shard_indices_cuda([0, 1], [5, 7], rounds=above)


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
    want = ck.epoch_indices_amortized_ref(TEN_B, 8192, 0, 1, 255, 256, ns,
                                          device="cuda")
    assert torch.equal(ck.index_amortized_wide(TEN_B, 8192, 0, 1, 255, 256),
                       want)
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
    for rank in (0, world - 1):
        want = general(n, window, seed, epoch, rank, world)
        assert torch.equal(general(n, window, None, None, rank, world,
                                   triple=t), want)
        assert torch.equal(amortized(n, window, None, None, rank, world,
                                     triple=t), want)
        assert torch.equal(amortized(n, window, seed, epoch, rank, world),
                           want)
        assert torch.equal(cuda.epoch_indices_cuda(
            n, window, None, None, rank, world, triple=t), want)
    with pytest.raises(ValueError, match="triple"):
        general(n, window, seed, epoch, 0, world, triple=t)
    with pytest.raises(ValueError, match="triple"):
        amortized(n, window, seed, epoch, 0, world, triple=t)
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


# ------------------------------------------------------------- mixture
from partiallyshuffledistributedsampler_tpu.ops import mixture as jmix  # noqa: E402
from partiallyshuffledistributedsampler_tpu_torch import (  # noqa: E402
    MixtureEpochIterator,
    MixtureSpec,
    PartialShuffleMixtureSampler,
    mixture_elastic_indices_cuda,
    mixture_epoch_indices_cuda,
    mixture_stream_at_cuda,
)
from partiallyshuffledistributedsampler_tpu_torch.ops import (  # noqa: E402
    mixture as pmix,
)

SIZES, WEIGHTS = [1000, 500, 2500], [5, 1, 4]
M3 = ([1_750_000_000] * 4 + [2_000_000_000, 1_000_000_000],
      [175] * 4 + [200, 100])
#: (sources, weights, spec kw, law kw, world, rank) for each (position,
#: id) type pair of the kernel: uint32/int32, uint64/int32, uint64/int64,
#: uint32/int64
MIX_CASES = [
    (SIZES, WEIGHTS, dict(windows=64, block=100), {}, 3, 2),
    (SIZES, WEIGHTS, dict(windows=64, block=100, pattern_version=1),
     dict(partition="blocked", order_windows=False), 3, 1),
    (SIZES, WEIGHTS, dict(windows=64, block=100), dict(shuffle=False), 2, 1),
    ([700_000, 200_000, 100_000], [70, 20, 10], dict(windows=8192),
     dict(epoch_samples=2**31 + 5000), 2**20, 777_777),
    (*M3, dict(windows=8192), {}, 2**22, 3_000_001),
    (*M3, dict(windows=8192), dict(epoch_samples=1_000_000), 4, 3),
    (SIZES, WEIGHTS, dict(windows=64, block=100), dict(rounds=64), 2, 0),
]


@pytest.mark.parametrize("sources,weights,skw,lkw,world,rank", MIX_CASES)
def test_mixture_kernels_match_numpy_and_plain(sources, weights, skw, lkw,
                                               world, rank):
    js = jmix.MixtureSpec(sources, weights, **skw)
    ps = MixtureSpec(sources, weights, **skw)
    ck.reset_launches()
    got = mixture_epoch_indices_cuda(ps, 42, 3, rank, world, **lkw)
    rounds = lkw.get("rounds", core.DEFAULT_ROUNDS)
    assert ck.launches["mixture_fused"] == 1
    # small specs fold their keys into mixture_fused: one launch a regen
    assert ck.launches["mixture_source_keys"] == int(
        not ck.mixture_folds(ps, rounds))
    _t, ns, total = pmix.mixture_epoch_sizes(ps, lkw.get("epoch_samples"),
                                             world, False)
    pos = (np.arange(ns, dtype=np.int64) * world + rank
           if lkw.get("partition", "strided") == "strided"
           else rank * ns + np.arange(ns, dtype=np.int64))
    want = jmix.mixture_stream_at_np(
        pos, js, 42, 3, **{k: v for k, v in lkw.items()
                           if k in ("shuffle", "order_windows", "rounds")})
    assert got.is_cuda and got.dtype == ps.out_dtype()
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    keys = ck.mixture_source_keys(ps, 42, 3, rounds=rounds)
    assert torch.equal(keys, ck.mixture_source_keys_ref(ps, 42, 3,
                                                        rounds=rounds,
                                                        device="cuda"))
    kw = dict(rank=rank, world=world, num_samples=ns,
              partition=lkw.get("partition", "strided"),
              wide_pos=total + ps.block > core.INT32_MAX,
              shuffle=lkw.get("shuffle", True),
              order_windows=lkw.get("order_windows", True), rounds=rounds)
    assert torch.equal(ck.mixture_fused(keys, ps, 42, 3, **kw),
                       ck.mixture_fused_ref(keys, ps, 42, 3, **kw))


def test_mixture_goldens_on_gpu():
    for pv, head in ((1, [394, 2255, 425, 2252, 411, 1363, 2260, 402]),
                     (2, [2255, 394, 2252, 425, 1363, 2260, 411, 2262])):
        spec = MixtureSpec(SIZES, WEIGHTS, windows=64, block=100,
                           pattern_version=pv)
        ids = mixture_epoch_indices_cuda(spec, 7, 3, 0, 1)
        assert ids[:8].tolist() == head and int(ids.long().sum()) == 5793243


def test_mixture_triple_and_300_sources():
    seed, epoch = (1 << 40) + 0xFFFFFFF7, 0xFFFFFFF0
    t = _triple(seed, epoch)
    spec = MixtureSpec([2000 + 17 * i for i in range(300)],
                       [1 + i % 13 for i in range(300)], windows=64,
                       block=4096)
    for fused in (None, False):
        want = mixture_epoch_indices_cuda(spec, seed, epoch, 5, 8,
                                          fused=fused)
        assert torch.equal(mixture_epoch_indices_cuda(
            spec, None, None, 5, 8, triple=t, fused=fused), want)
    js = jmix.MixtureSpec([2000 + 17 * i for i in range(300)],
                          [1 + i % 13 for i in range(300)], windows=64,
                          block=4096)
    np.testing.assert_array_equal(
        want.cpu().numpy(),
        jmix.mixture_epoch_indices_np(js, seed, epoch, 5, 8))


def test_mixture_stream_at_and_elastic_on_gpu():
    js = jmix.MixtureSpec(SIZES, WEIGHTS, windows=64, block=100)
    ps = MixtureSpec(SIZES, WEIGHTS, windows=64, block=100)
    pos = np.random.default_rng(0).integers(0, 10**7, 5000)
    ck.reset_launches()
    got = mixture_stream_at_cuda(pos, ps, 5, 1)
    assert ck.launches["mixture_fused"] == 1
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  jmix.mixture_stream_at_np(pos, js, 5, 1))
    for layers in ([(3, 400)], [(4, 100), (3, 7)]):
        for rank in range(2):
            got = mixture_elastic_indices_cuda(ps, 5, 1, rank, 2, layers)
            np.testing.assert_array_equal(
                got.cpu().numpy(),
                jmix.mixture_elastic_indices_np(js, 5, 1, rank, 2, layers))


def test_mixture_sampler_iterator_and_runner_launches():
    js = jmix.MixtureSpec(SIZES, WEIGHTS, windows=64, block=100)
    s = PartialShuffleMixtureSampler(SIZES, WEIGHTS, num_replicas=3, rank=2,
                                     windows=64, block=100)
    s.set_epoch(4)
    assert list(s) == jmix.mixture_epoch_indices_np(js, 0, 4, 2, 3).tolist()
    it = MixtureEpochIterator(MixtureSpec(SIZES, WEIGHTS, windows=64,
                                          block=100), 64, rank=1, world=2)
    ck.reset_launches()
    total = it.run_epochs(2, 3, lambda c, b: c + b.sum(),
                          torch.zeros((), dtype=torch.int64, device="cuda"))
    assert ck.launches["mixture_fused"] == 3  # one kernel regen per epoch
    assert ck.launches["index_amortized"] == ck.launches["index_general"] == 0
    whole = it.steps_per_epoch * 64
    assert int(total) == sum(int(jmix.mixture_epoch_indices_np(
        js, 0, e, 1, 2)[:whole].sum()) for e in (2, 3, 4))


# ---------------------------------------------------- shard mode (§7)
_SHARD_RNG = np.random.default_rng(11)
#: (id, shard sizes, shard-id stream)
SHARD_CASES = [
    ("uniform", [1000] * 300, _SHARD_RNG.permutation(300)[:200]),
    ("mixed", _SHARD_RNG.integers(0, 90, 200).tolist(),
     _SHARD_RNG.permutation(200)[:150]),
    ("many-sizes", np.concatenate([_SHARD_RNG.integers(1, 400, 300),
                                   [0, 0, 1, 1, 2],
                                   _SHARD_RNG.integers(200, 2000, 200)]),
     _SHARD_RNG.permutation(505)[:400]),
]
SHARD_MODES = [True, 1, False, 9, np.int64(9), 64, 5000]


@pytest.mark.parametrize("cid,sizes,ids", SHARD_CASES,
                         ids=[c[0] for c in SHARD_CASES])
def test_shard_kernels_match_host_and_plain(cid, sizes, ids):
    tabs = S.shard_tables(sizes, "cuda")
    sids = torch.from_numpy(np.asarray(ids, dtype=np.int32)).cuda()
    for wss in SHARD_MODES:
        full, w = S.shuffle_mode(wss)
        for epoch in (0, 5):
            want = shard_mode.expand_shard_indices_cpu(
                ids, sizes, seed=4, epoch=epoch, within_shard_shuffle=wss)
            ck.reset_launches()
            for shard_ids in (ids, sids):  # from the host, from the card
                got = shard_mode.expand_shard_indices_cuda(
                    shard_ids, sizes, seed=4, epoch=epoch,
                    within_shard_shuffle=wss)
                assert got.is_cuda and got.dtype == torch.int32
                np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
            assert ck.launches["shard_expand"] == 2
            # sequential mode reads no record, so it computes none
            assert ck.launches["shard_row_keys"] == (
                0 if S.sequential(full, w) else 2)
            plain = shard_mode.expand_shard_indices_generic(
                sids, sizes, seed=4, epoch=epoch, within_shard_shuffle=wss)
            assert torch.equal(got, plain)
            rows, _m = ck.shard_row_keys(sids, tabs, 4, epoch, full=full,
                                         w=w)
            rows_ref, _m = ck.shard_row_keys_ref(sids, tabs.dev_sizes, 4,
                                                 epoch, full=full, w=w)
            assert torch.equal(rows, rows_ref)


def test_shard_goldens_and_int64_space_on_gpu():
    sizes = [5, 0, 7, 3, 4]
    got = shard_mode.expand_shard_indices_cuda([2, 0, 3], sizes, seed=3,
                                               epoch=1)
    assert got.tolist() == [10, 8, 11, 6, 7, 9, 5, 1, 2, 0, 3, 4, 13, 12, 14]
    got = shard_mode.expand_shard_indices_cuda(
        [2, 0, 3], sizes, seed=3, epoch=1, within_shard_shuffle=2)
    assert got.tolist() == [5, 6, 8, 7, 9, 10, 11, 0, 1, 3, 2, 4, 12, 13, 14]
    big = [10**9, 1_500_000_000, 7, 5, 9]
    for wss in (True, 3, False):
        got = shard_mode.expand_shard_indices_cuda(
            [3, 2, 4], big, seed=9, epoch=2, within_shard_shuffle=wss)
        want = shard_mode.expand_shard_indices_cpu(
            [3, 2, 4], big, seed=9, epoch=2, within_shard_shuffle=wss)
        assert got.dtype == torch.int64 and int(got.min()) > 2**31
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


def test_shard_device_triple_matches_scalars():
    seed, epoch = (1 << 40) + 0xFFFFFFF7, 0xFFFFFFF0
    sizes = _SHARD_RNG.integers(0, 300, 400).tolist()
    ids = _SHARD_RNG.permutation(400)
    for wss in (True, 17):
        got = shard_mode.expand_shard_indices_cuda(
            ids, sizes, seed=None, epoch=None, within_shard_shuffle=wss,
            triple=_triple(seed, epoch))
        want = shard_mode.expand_shard_indices_cuda(
            ids, sizes, seed=seed, epoch=epoch, within_shard_shuffle=wss)
        assert torch.equal(got, want)


#: (rows, rounds) of shard_row_keys, whose blocks take 32 rows each and
#: whose threads write runs of 4 constants (16-byte stores when rounds % 4
#: == 0): fewer rows than a block, a block and one more row, a ragged last
#: block, the S1/world-8 row count, and rounds 0, 1, 2, 6, 24 and 64
ROW_KEY_CASES = [(1, 24), (31, 2), (33, 1), (1000, 0), (257, 6),
                 (4097, 64), (12_500, 24)]


@pytest.mark.parametrize("rows,rounds", ROW_KEY_CASES)
def test_shard_row_keys_word_for_word(rows, rounds):
    rng = np.random.default_rng(rows + rounds)
    sizes = rng.integers(0, 3000, 2 * rows + 7)
    sizes[::5] = 0  # zero-size shards
    sizes[1::7] = 1
    tabs = S.shard_tables(sizes, "cuda")
    sids = torch.from_numpy(
        rng.permutation(sizes.size)[:rows].astype(np.int32)).cuda()
    seed, epoch = (1 << 40) + 0xFFFFFFF7, 0xFFFFFFF0
    t = _triple(seed, epoch)
    for wss in (True, 64, 1, False):
        full, w = S.shuffle_mode(wss)
        want, m_want = ck.shard_row_keys_ref(sids, tabs.dev_sizes, seed,
                                             epoch, full=full, w=w,
                                             rounds=rounds)
        ck.reset_launches()
        got, m_of = ck.shard_row_keys(sids, tabs, seed, epoch, full=full,
                                      w=w, rounds=rounds, sizes_out=True)
        got_t, no_sizes = ck.shard_row_keys(sids, tabs, None, None,
                                            full=full, w=w, rounds=rounds,
                                            triple=t)
        assert ck.launches["shard_row_keys"] == 2
        assert got.numel() == rows * S.row_words(rounds)
        assert torch.equal(got, want) and torch.equal(got_t, want)
        assert torch.equal(m_of, m_want) and no_sizes is None


def test_shard_sampler_device_epoch_indices_on_gpu():
    sizes = [25] * 64
    mixed = [(7 * i) % 41 for i in range(64)]
    s = shard_mode.PartialShuffleShardSampler(64, num_replicas=4, rank=2,
                                              seed=6)
    s.set_epoch(3)
    pending = s._pending
    shard_ids = jcpu.epoch_indices_np(64, 64, 6, 3, 2, 4)
    ck.reset_launches()
    for sz, wss in ((sizes, 5), (mixed, True)):
        got = s.device_epoch_indices(sz, within_shard_shuffle=wss)
        assert got.is_cuda
        want = shard_mode.expand_shard_indices_cpu(
            shard_ids, sz, seed=6, epoch=3, within_shard_shuffle=wss)
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    assert ck.launches["shard_expand"] == 2
    assert s._pending is pending and s.state_dict()["offset"] == 0
    assert list(s) == shard_ids.tolist()
    assert s._pending is None


# ------------------------------------------------- rounds above 64 (all)
#: the round counts SPEC.md §2 cites (~102, ~121) and 65, held against the
#: numpy reference too; and the limit
HIGH_ROUNDS = (65, 102, 121)
ROUND_CASES = [*HIGH_ROUNDS, ck.MAX_ROUNDS]


@pytest.mark.parametrize("rounds", ROUND_CASES)
def test_index_kernels_at_high_rounds(rounds):
    """Both index kernels in both widths against their plain versions, and
    at the cited counts against the numpy reference: a tail window, and
    the schedules in dynamic shared memory past 48 KB at the limit."""
    for n, window, world, rank in ((100_000, 8192, 8, 3), (1000, 64, 4, 1),
                                   (N31, 8192, 8192, 8191)):
        wide = core.is_wide(n)
        general = ck.index_general_wide if wide else ck.index_general
        amortized = ck.index_amortized_wide if wide else ck.index_amortized
        ns, _ = core.shard_sizes(n, world, False)
        want = ck.index_general_ref(n, window, 5, 2, rank, world,
                                    rounds=rounds, device="cuda")
        ck.reset_launches()
        assert torch.equal(general(n, window, 5, 2, rank, world,
                                   rounds=rounds), want)
        assert torch.equal(general(n, window, 5, 2, rank, world,
                                   partition="blocked", rounds=rounds),
                           ck.index_general_ref(n, window, 5, 2, rank, world,
                                                partition="blocked",
                                                rounds=rounds, device="cuda"))
        got = amortized(n, window, 5, 2, rank, world, rounds=rounds)
        assert sum(ck.launches.values()) == 3
        assert torch.equal(got, want)
        assert torch.equal(got, ck.epoch_indices_amortized_ref(
            n, window, 5, 2, rank, world, ns, rounds=rounds, device="cuda"))
        if rounds in HIGH_ROUNDS and ns <= 100_000:
            np.testing.assert_array_equal(
                got.cpu().numpy(), jcpu.epoch_indices_np(
                    n, window, 5, 2, rank, world, rounds=rounds))


@pytest.mark.parametrize("rounds", ROUND_CASES)
def test_mixture_kernels_at_high_rounds(rounds):
    """The source keys and the fused kernel, keys folded where the spec
    folds and given by mixture_source_keys everywhere, against their plain
    versions and the numpy reference."""
    for pv in (1, 2):
        skw = dict(windows=64, block=100, pattern_version=pv)
        js, ps = (jmix.MixtureSpec(SIZES, WEIGHTS, **skw),
                  MixtureSpec(SIZES, WEIGHTS, **skw))
        keys = ck.mixture_source_keys(ps, 42, 3, rounds=rounds)
        assert torch.equal(keys, ck.mixture_source_keys_ref(
            ps, 42, 3, rounds=rounds, device="cuda"))
        _t, ns, total = pmix.mixture_epoch_sizes(ps, None, 3, False)
        kw = dict(rank=1, world=3, num_samples=ns, wide_pos=False,
                  rounds=rounds)
        want = ck.mixture_fused_ref(keys, ps, 42, 3, **kw)
        assert torch.equal(ck.mixture_fused(keys, ps, 42, 3, **kw), want)
        if ck.mixture_folds(ps, rounds):
            assert torch.equal(ck.mixture_fused(None, ps, 42, 3, **kw), want)
        got = mixture_epoch_indices_cuda(ps, 42, 3, 1, 3, rounds=rounds)
        assert torch.equal(got, want)
        if rounds in HIGH_ROUNDS:
            np.testing.assert_array_equal(
                got.cpu().numpy(),
                jmix.mixture_epoch_indices_np(js, 42, 3, 1, 3, rounds=rounds))


@pytest.mark.parametrize("rounds", ROUND_CASES)
def test_shard_kernels_at_high_rounds(rounds):
    """shard_row_keys word for word (65 and 121 take the scalar tail of its
    runs of four) and shard_expand against their plain versions and the
    numpy reference, with a zero-size shard; past 1,536 rounds no row's
    constants fit the tile's stage and every lane reads the records."""
    rng = np.random.default_rng(rounds)
    sizes = rng.integers(0, 300, 400)
    sizes[::9] = 0
    ids = rng.permutation(400)[:300]
    tabs = S.shard_tables(sizes, "cuda")
    sids = torch.from_numpy(ids.astype(np.int32)).cuda()
    for wss in (True, 17, False):
        full, w = S.shuffle_mode(wss)
        rows, _m = ck.shard_row_keys(sids, tabs, 4, 1, full=full, w=w,
                                     rounds=rounds)
        assert torch.equal(rows, ck.shard_row_keys_ref(
            sids, tabs.dev_sizes, 4, 1, full=full, w=w, rounds=rounds)[0])
        got = shard_mode.expand_shard_indices_cuda(
            sids, sizes, seed=4, epoch=1, within_shard_shuffle=wss,
            rounds=rounds)
        assert torch.equal(got, shard_mode.expand_shard_indices_generic(
            sids, sizes, seed=4, epoch=1, within_shard_shuffle=wss,
            rounds=rounds))
        if rounds in HIGH_ROUNDS:
            np.testing.assert_array_equal(
                got.cpu().numpy(), shard_mode.expand_shard_indices_cpu(
                    ids, sizes, seed=4, epoch=1, within_shard_shuffle=wss,
                    rounds=rounds).numpy())


#: the JAX sampler's checkpoint at rounds=102 (the CPU test
#: test_torch_port_rounds.py::test_jax_checkpoint_at_rounds_102_loads_into_the_port
#: holds the JAX sampler to writing exactly this dict)
JAX_CKPT_R102 = {
    "spec_version": 2, "kind": "single", "seed": 11, "epoch": 2,
    "offset": 1000, "n": 100000, "num_replicas": 8, "window": 8192,
    "rounds": 102, "order_windows": True, "partition": "strided",
    "shuffle": True, "drop_last": False,
}


def test_jax_checkpoint_at_rounds_102_regenerates_on_the_card():
    want = jcpu.epoch_indices_np(100_000, 8192, 11, 2, 3, 8, rounds=102)
    ts = PartiallyShuffleDistributedSampler(100_000, 8, 3, window=8192,
                                            seed=11, rounds=102)
    ts.load_state_dict(JAX_CKPT_R102)
    ck.reset_launches()
    assert list(ts) == want[1000:].tolist()
    ts.set_epoch(3)
    assert list(ts) == jcpu.epoch_indices_np(100_000, 8192, 11, 3, 3, 8,
                                             rounds=102).tolist()
    assert ck.launches["index_amortized"] > 0
    for world, rank in ((8, 3), (5, 4)):
        got = PartiallyShuffleDistributedSampler.reshard_from_state_dict(
            JAX_CKPT_R102, world, rank)
        ref = PartiallyShuffleDistributedSampler.reshard_from_state_dict(
            JAX_CKPT_R102, world, rank, backend="cpu")
        assert got.rounds == 102 and list(got) == list(ref)
        got.set_epoch(3)
        assert list(got) == jcpu.epoch_indices_np(
            100_000, 8192, 11, 3, rank, world, rounds=102).tolist()


# --------------------------------------------- shard_expand tile edges
def _tile_case(name):
    """(sizes, ids) of one tile-edge case of the redesigned shard_expand
    (tiles of up to 4,096 lanes, 64 staged rows)."""
    rng = np.random.default_rng(len(name))
    if name == "rows-cut-by-tiles":  # uniform 1000: rows straddle tiles
        return np.full(20_000, 1000), rng.permutation(20_000)
    if name == "tile-inside-one-row":  # S3's 50,000..100,000 rows
        sizes = np.concatenate([rng.integers(50_000, 100_001, 40),
                                rng.integers(4, 65, 400)])
        return sizes, rng.permutation(sizes.size)
    if name == "more-rows-than-staged":  # zero and tiny rows
        sizes = rng.integers(0, 4, 3_000_000)
        return sizes, rng.permutation(sizes.size)
    if name == "zero-size-rows":
        sizes = rng.integers(0, 2000, 6000)
        sizes[rng.random(6000) < 0.3] = 0
        return sizes, rng.permutation(sizes.size)
    if name == "partial-last-tile":  # 12,345 x 997 lanes, uniform
        return np.full(12_345, 997), rng.permutation(12_345)
    if name == "one-lane-rows":
        return np.ones(100_000, dtype=np.int64), rng.permutation(100_000)
    raise KeyError(name)


TILE_CASES = ["rows-cut-by-tiles", "tile-inside-one-row",
              "more-rows-than-staged", "zero-size-rows",
              "partial-last-tile", "one-lane-rows"]


@pytest.mark.parametrize("name", TILE_CASES)
def test_shard_expand_at_tile_edges(name):
    sizes, ids = _tile_case(name)
    sids = torch.from_numpy(ids.astype(np.int32)).cuda()
    for wss in (True, 64, 5, False):
        ck.reset_launches()
        got = shard_mode.expand_shard_indices_cuda(
            sids, sizes, seed=3, epoch=2, within_shard_shuffle=wss)
        seq = S.sequential(*S.shuffle_mode(wss))
        assert ck.launches["shard_expand"] == 1
        assert ck.launches["shard_row_keys"] == int(not seq)
        want = shard_mode.expand_shard_indices_generic(
            sids, sizes, seed=3, epoch=2, within_shard_shuffle=wss)
        assert got.dtype == want.dtype and torch.equal(got, want), wss
        # from the host too (the prefix uploaded, not read back)
        assert torch.equal(shard_mode.expand_shard_indices_cuda(
            ids, sizes, seed=3, epoch=2, within_shard_shuffle=wss), want)


@pytest.mark.parametrize("big", [False, True])
def test_shard_sequential_copy_at_unaligned_row_starts(big):
    """Sequential mode writes 16 bytes a thread where four (int32) or two
    (int64) lanes lie in one row; odd sizes put row starts at every
    alignment."""
    rng = np.random.default_rng(7)
    sizes = rng.integers(0, 12, 50_000) * 2 + 1
    sizes[::13] = 0
    if big:  # an int64 space: shards 0 and 1 push every offset past 2^31
        sizes = np.concatenate([[2**30, 2**30 + 7], sizes])
    ids = rng.permutation(sizes.size)
    ids = ids[ids > 1] if big else ids
    for wss in (False, 0, 1):
        got = shard_mode.expand_shard_indices_cuda(ids, sizes, seed=1,
                                                   within_shard_shuffle=wss)
        want = shard_mode.expand_shard_indices_cpu(ids, sizes, seed=1,
                                                   within_shard_shuffle=wss)
        assert got.dtype == (torch.int64 if big else torch.int32)
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


def test_shard_expand_past_2_31_lanes():
    """A selection of 2^31 + 65,536 lanes: the kernel's 64-bit lane counter
    and its 64-bit magic number, held on rows around lane 2^31 (17 GB of
    int64)."""
    m, rows = 65_536, 32_769
    sizes = np.full(rows, m)
    sids = torch.arange(rows, dtype=torch.int32, device="cuda").flip(0)
    out = shard_mode.expand_shard_indices_cuda(sids, sizes, seed=2, epoch=1)
    assert out.numel() == rows * m and out.dtype == torch.int64
    pick = torch.tensor([0, 1, 32_766, 32_767, 32_768], device="cuda")
    assert torch.equal(out.view(rows, m)[pick].reshape(-1),
                       shard_mode.expand_shard_indices_generic(
                           sids[pick], sizes, seed=2, epoch=1))
    del out
    torch.cuda.empty_cache()


# ------------------------------------------------ the fold (mixture)
#: (sources, rounds): specs that fold (3 and 7 sources at 24 rounds, 3 at
#: 40) and specs that do not (8 and 25 sources at 24 rounds, 3 at 121:
#: their keys are still staged, so the kernel can derive them; 300
#: sources, whose keys are not)
FOLD_CASES = [((1000, 500, 2500), 24), ((500,) * 7, 24),
              ((1000, 500, 2500), 40), ((500,) * 8, 24), ((500,) * 25, 24),
              ((1000, 500, 2500), 121), ((500,) * 300, 24)]


@pytest.mark.parametrize("sources,rounds", FOLD_CASES)
def test_mixture_fold_on_both_sides_of_the_threshold(sources, rounds):
    seed, epoch = (1 << 40) + 0xFFFFFFF7, 0xFFFFFFF0
    t = _triple(seed, epoch)
    spec = MixtureSpec(list(sources), [1 + i % 5 for i in range(len(sources))],
                       windows=64, block=4096)
    folds = ck.mixture_folds(spec, rounds)
    staged = (ck.mixture_key_words(spec, rounds) + 8 * len(sources)
              <= ck.STAGE_WORDS_CAP)
    keys = ck.mixture_source_keys_ref(spec, seed, epoch, rounds=rounds,
                                      device="cuda")
    _t, ns, total = pmix.mixture_epoch_sizes(spec, None, 3, False)
    kw = dict(rank=2, world=3, num_samples=ns, wide_pos=False, rounds=rounds)
    want = ck.mixture_fused_ref(keys, spec, seed, epoch, **kw)
    if staged:  # the kernel derives the keys it stages
        assert torch.equal(ck.mixture_fused(None, spec, seed, epoch, **kw),
                           want)
        assert torch.equal(ck.mixture_fused(None, spec, None, None,
                                            triple=t, **kw), want)
    else:
        with pytest.raises(ValueError, match="staged words"):
            ck.mixture_fused(None, spec, seed, epoch, **kw)
    for s, e, tr in ((seed, epoch, None), (None, None, t)):
        ck.reset_launches()
        got = mixture_epoch_indices_cuda(spec, s, e, 2, 3, rounds=rounds,
                                         triple=tr)
        assert ck.launches["mixture_fused"] == 1
        assert ck.launches["mixture_source_keys"] == int(not folds)
        assert torch.equal(got, want)
        pos = torch.arange(0, 50_000, 7, device="cuda")
        ck.reset_launches()
        got = mixture_stream_at_cuda(pos, spec, seed, epoch, rounds=rounds)
        assert sum(ck.launches.values()) == 2 - int(folds)
        assert torch.equal(got, ck.mixture_fused_ref(
            keys, spec, seed, epoch, positions=pos, wide_pos=False,
            rounds=rounds))


# ------------------------------------------- the elastic remainder, access
def _deep_layers(n: int, depth: int, seed: int, worlds=(2, 3, 5, 8)):
    """tests/test_torch_port_elastic.py deep_layers: a cascade of ``depth``
    layers from a numpy seed, each consuming 0..2 samples a rank."""
    rng = np.random.default_rng(seed)
    layers, domain = [], n
    for _ in range(depth):
        world = int(rng.choice(worlds))
        ns = -(-domain // world)
        consumed = int(rng.integers(0, min(2, ns - 1) + 1))
        layers.append((world, consumed))
        domain = (ns - consumed) * world
    return layers


_HUGE_WORLDS = [(3, 5), (2**30 + 7, 0), (2**31 - 1, 0)]
_TEN_B_LAYER = [(8192, 1_220_000)]
#: (n, window, new world, layers, law kwargs) of the remainder on the card:
#: the CPU cases of tests/test_torch_port_elastic.py, rounds 65, 121 and
#: 4,096, and 64-layer chains narrow and wide
ELASTIC_CASES = [
    (100_000, 512, 6, [(8, 3000)], {}),
    (100_000, 512, 6, [(8, 3000)], {"partition": "blocked"}),
    (100_003, 512, 5, [(8, 3000), (6, 100), (3, 17)], {"drop_last": True}),
    (100_003, 512, 5, [(8, 3000), (6, 100), (3, 17)],
     {"partition": "blocked"}),
    (50_000, 256, 3, [(4, 2000), (7, 11)], {"order_windows": False}),
    (50_000, 256, 3, [(4, 2000), (7, 11)], {"shuffle": False}),
    (50_000, 256, 3, [(4, 2000)], {"rounds": 0}),
    (50_000, 256, 3, [(4, 2000)], {"rounds": 65}),
    (50_000, 256, 3, [(4, 2000)], {"rounds": 102}),
    (50_000, 256, 3, [(4, 2000)], {"rounds": 121, "partition": "blocked"}),
    (50_000, 256, 3, [(4, 12000)], {"rounds": ck.MAX_ROUNDS}),
    (1_000_000, 4096, 7, _deep_layers(1_000_000, 64, 1), {}),
    (1_000_000, 4096, 7, _deep_layers(1_000_000, 64, 2),
     {"partition": "blocked"}),
    (2**31 - 1, 8192, 2**31 - 1, _HUGE_WORLDS, {}),
    (2**31 - 1, 8192, 2**31 - 1, _HUGE_WORLDS, {"partition": "blocked"}),
    (TEN_B, 8192, 4096, _TEN_B_LAYER, {}),
    (TEN_B, 8192, 4096, _TEN_B_LAYER + [(1000, 5000), (4096, 10)],
     {"partition": "blocked"}),
    (TEN_B, 8192, 4096, _TEN_B_LAYER + _deep_layers(5_758_976, 63, 3), {}),
    (TEN_B, 8192, 4096, _TEN_B_LAYER + _deep_layers(5_758_976, 63, 3),
     {"partition": "blocked", "rounds": 121}),
    (2**31 + 1, 8192, 3, [(2, 2**30 - 1000)], {"rounds": 65}),
    (2**31 + 1, 8192, 3, [(2, 2**30 - 1000)],
     {"shuffle": False, "partition": "blocked"}),
    (2**32 + 4097, 8192, 16, [(2, 2**31 - 1000)],
     {"drop_last": True, "rounds": ck.MAX_ROUNDS}),
]


def _elastic_id(c):
    n, window, world, layers, kw = c
    return (f"n{n}-w{window}-world{world}-{len(layers)}layers-"
            + "-".join(f"{k}{v}" for k, v in kw.items()))


@pytest.mark.parametrize("case", ELASTIC_CASES, ids=_elastic_id)
def test_positions_kernels_remainder_match_plain_and_numpy(case):
    n, window, world, layers, kw = case
    chain, _remaining, ns = core.elastic_chain(n, layers, world,
                                               kw.get("drop_last", False))
    law = {k: v for k, v in kw.items() if k != "drop_last"}
    name = "index_positions_wide" if core.is_wide(n) else "index_positions"
    for rank in sorted({0, world // 2, world - 1}):
        ck.reset_launches()
        got = cuda.elastic_indices_cuda(n, window, 42, 3, rank, world, ns,
                                        chain, **law)
        torch.cuda.synchronize()
        # one launch of the positions kernel, no plain torch law
        assert ck.launches[name] == 1 and sum(ck.launches.values()) == 1
        assert got.is_cuda and got.dtype == core.out_dtype(n)
        assert torch.equal(got, ck.index_positions_ref(
            n, window, 42, 3, rank=rank, world=world, num_samples=ns,
            chain=chain, device="cuda", **law))
        np.testing.assert_array_equal(
            got.cpu().numpy(),
            jcpu.elastic_indices_np(n, window, 42, 3, rank, world, layers,
                                    **kw))


#: random-access probes: ordinary, past one epoch, negative and huge
_PROBES = np.concatenate([
    np.arange(4), [-1, -2, -(2**31), -(2**63), 2**63 - 1, 2**32, 2**32 - 1],
    np.random.default_rng(7).integers(-(2**63), 2**63 - 1, 4096,
                                      dtype=np.int64),
    np.random.default_rng(8).integers(0, 3 * TEN_B, 4096),
]).astype(np.int64)


@pytest.mark.parametrize("n,window", [(100_000, 512), (2**31 - 1, 8192),
                                      (2**31 + 1, 8192), (TEN_B, 8192)])
@pytest.mark.parametrize("rounds", [24, 65, 121, ck.MAX_ROUNDS])
def test_positions_kernels_random_access(n, window, rounds):
    name = "index_positions_wide" if core.is_wide(n) else "index_positions"
    probes = _PROBES if rounds in (24, 65) else _PROBES[:1024]
    for shuffle in (True, False):
        ck.reset_launches()
        got = cuda.stream_indices_at_cuda(probes, n, window, 42, 3,
                                          shuffle=shuffle, rounds=rounds)
        torch.cuda.synchronize()
        assert ck.launches[name] == 1 and sum(ck.launches.values()) == 1
        assert got.is_cuda and got.dtype == core.out_dtype(n)
        assert torch.equal(got, ck.index_positions_ref(
            n, window, 42, 3, positions=torch.from_numpy(probes).cuda(),
            shuffle=shuffle, rounds=rounds))
        np.testing.assert_array_equal(
            got.cpu().numpy(),
            jcpu.stream_indices_at_np(probes, n, window, 42, 3,
                                      shuffle=shuffle, rounds=rounds))


def test_negative_position_on_the_card():
    """n = 2^31 + 1, p = -1 is p = 2^64 - 1 as uint64: stream(p) =
    pi(3); a 2-D int32 tensor of positions keeps its shape."""
    n = 2**31 + 1
    assert cuda.stream_indices_at_cuda([-1], n, 8192, 0, 0,
                                       shuffle=False).tolist() == [3]
    np.testing.assert_array_equal(
        cuda.stream_indices_at_cuda([-1], n, 8192, 0, 0).cpu().numpy(),
        jcpu.stream_indices_at_np(np.array([-1]), n, 8192, 0, 0))
    p = torch.from_numpy(_PROBES[:64].astype(np.int32).reshape(8, 8))
    got = cuda.stream_indices_at_cuda(p, 100_000, 512, 5, 1)
    assert got.shape == (8, 8)
    np.testing.assert_array_equal(
        got.cpu().numpy().ravel(),
        jcpu.stream_indices_at_np(p.numpy().ravel(), 100_000, 512, 5, 1))


def test_positions_kernels_device_triple_and_refusals():
    chain, _r, ns = core.elastic_chain(TEN_B, _TEN_B_LAYER, 4096)
    bits = np.array(core.seed_triple(0x1_0000_0007, 3), dtype=np.uint32)
    triple = torch.from_numpy(bits.view(np.int32)).cuda()
    want = cuda.elastic_indices_cuda(TEN_B, 8192, 0x1_0000_0007, 3, 7, 4096,
                                     ns, chain)
    assert torch.equal(want, cuda.elastic_indices_cuda(
        TEN_B, 8192, None, None, 7, 4096, ns, chain, triple=triple))
    # the same refusals as the plain route (tests/test_torch_port_elastic.py)
    with pytest.raises(ValueError, match="fully consumed"):
        ck.index_positions(1000, 64, 0, 0, rank=0, world=2, num_samples=10,
                           chain=((2, 500, 500),))
    with pytest.raises(ValueError, match="rank"):
        ck.index_positions(1000, 64, 0, 0, rank=2, world=2, num_samples=10,
                           chain=((2, 500, 490),))
    with pytest.raises(ValueError, match="rounds"):
        ck.index_positions(1000, 64, 0, 0, rank=0, world=2, num_samples=10,
                           chain=((2, 500, 490),),
                           rounds=ck.MAX_ROUNDS + 1)


#: tests/test_torch_port_elastic.py::JAX_CKPT_ELASTIC: the JAX sampler's
#: checkpoint after a reshard 8 -> 6 at offset 1000, 500 samples on
JAX_CKPT_ELASTIC = {
    "spec_version": 2, "kind": "single", "seed": 11, "epoch": 2,
    "offset": 500, "n": 100000, "num_replicas": 6, "window": 8192,
    "rounds": 24, "order_windows": True, "partition": "strided",
    "shuffle": True, "drop_last": False, "elastic": {"layers": [[8, 1000]]},
}


def test_sampler_elastic_remainder_from_jax_checkpoint_on_the_card():
    for rank in range(6):  # resumed at the checkpoint's world
        ck.reset_launches()
        s = PartiallyShuffleDistributedSampler(100_000, 6, rank, window=8192,
                                               seed=11)
        s.load_state_dict(dict(JAX_CKPT_ELASTIC))
        want = jcpu.elastic_indices_np(100_000, 8192, 11, 2, rank, 6,
                                       [(8, 1000)])
        assert list(s) == want[500:].tolist()
        assert ck.launches["index_positions"] == 1
    for rank in range(4):  # resharded 6 -> 4 from it
        ck.reset_launches()
        s = PartiallyShuffleDistributedSampler.reshard_from_state_dict(
            dict(JAX_CKPT_ELASTIC), 4, rank)
        assert s.backend == "cuda"
        assert list(s) == jcpu.elastic_indices_np(
            100_000, 8192, 11, 2, rank, 4, [(8, 1000), (6, 500)]).tolist()
        assert ck.launches["index_positions"] == 1


def test_elastic_regen_fn_on_the_agreed_triple_without_host_sync():
    import torch.distributed as dist

    from partiallyshuffledistributedsampler_tpu_torch import parallel

    owned = not dist.is_initialized()
    if owned:
        import socket

        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                                rank=0, world_size=1)
    try:
        mesh = parallel.data_mesh()
        layers = [(256, 39_062_000)]
        fn, ns = parallel.make_elastic_regen_fn(TEN_B, 8192, layers,
                                                mesh=mesh)
        triple = parallel.make_seed_triple(5, 2, mesh=mesh)
        fn(triple)  # warm-up: the communicator, the allocator
        torch.cuda.synchronize()
        ck.reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = fn(triple)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        assert ck.launches["index_positions_wide"] == 1
        assert sum(ck.launches.values()) == 1
        assert got.numel() == ns
        np.testing.assert_array_equal(
            got.cpu().numpy(),
            jcpu.elastic_indices_np(TEN_B, 8192, 5, 2, 0, 1, layers))
    finally:
        if owned:
            dist.destroy_process_group()


# ------------------------------------------ slice 8: HostDataLoader on the card
from partiallyshuffledistributedsampler_tpu_torch import (  # noqa: E402
    HostDataLoader,
    MixtureSpec as PortMixtureSpec,
    PartialShuffleSpec,
    StreamSpec,
)

LN, LWIN, LBATCH = 20_000, 512, 256
LMIX = ([9_000, 6_000, 5_000], [5, 2, 3], dict(windows=256, block=100))
LSHARDS = np.random.default_rng(8).integers(50, 150, 200)

#: mode: (loader kwargs, kernels a regen launches, a §6 cascade for it,
#: kernels its remainder regen launches)
LOADER_MODES = {
    "plain": (dict(window=LWIN, world=4, rank=1), ("index_amortized",),
              [(3, 300)], ("index_positions",)),
    "blocked": (dict(window=LWIN, world=4, rank=3, partition="blocked"),
                ("index_general",), [(3, 300)], ("index_positions",)),
    "mixture": (dict(world=4, rank=2, mixture="mix"), ("mixture_fused",),
                [(3, 300)], ("mixture_fused",)),
    "mixture_per_source": (dict(world=4, rank=2, mixture="mix",
                                per_source=True), ("mixture_fused",),
                           [(3, 300)], ("mixture_fused",)),
    "shard": (dict(window=8, world=4, rank=1, shard_sizes=LSHARDS),
              ("index_amortized", "shard_row_keys", "shard_expand"),
              [(3, 2)], ("index_positions", "shard_row_keys",
                         "shard_expand")),
    "stream_plain": (dict(window=LWIN, world=4, rank=0, streaming=True,
                          horizon=5_000), ("index_amortized",), [(3, 300)],
                     ("index_positions",)),
    "stream_mixture": (dict(world=4, rank=3, mixture="mix", streaming=True,
                            horizon=5_000), ("mixture_fused",), [(3, 300)],
                       ("mixture_fused",)),
}


def _loader(index_backend, device, data=None, **kw):
    kw = dict(kw)
    total = (int(LSHARDS.sum()) if "shard_sizes" in kw
             else sum(LMIX[0]) if kw.get("mixture") else LN)
    if data is None:
        data = {"x": np.arange(total, dtype=np.int64) * 3,
                "t": (np.arange(total * 4, dtype=np.uint16)
                      .reshape(total, 4))}
    if kw.pop("per_source", False):
        cut = np.cumsum(LMIX[0])[:-1]
        data = [dict(zip(data, parts)) for parts in
                zip(*(np.split(v, cut) for v in data.values()))]
    if kw.get("mixture") == "mix":
        kw["mixture"] = PortMixtureSpec(LMIX[0], LMIX[1], **LMIX[2])
    kw.setdefault("batch", LBATCH)
    return HostDataLoader(data, index_backend=index_backend, device=device,
                          **kw)


def _as_bits(t):
    """A batch as comparable host bits (uint16 travels as int16)."""
    if t.dtype == torch.uint16:
        t = t.view(torch.int16)
    return t.cpu().numpy()


@pytest.mark.parametrize("mode", list(LOADER_MODES))
def test_loader_on_the_card_matches_the_cpu_route(mode):
    kw, kernels, layers, layer_kernels = LOADER_MODES[mode]
    card = _loader("cuda", "cuda", boundary_prefetch=False, **kw)
    host = _loader("cpu", "cpu", boundary_prefetch=False, **kw)
    for epoch, ly, launched in ((1, None, kernels), (2, None, kernels),
                                (1, layers, layer_kernels)):
        ck.reset_launches()
        got = list(card.epoch(epoch, layers=ly))
        regen = {k: v for k, v in ck.launches.items() if v}
        assert regen == {k: 1 for k in launched}  # one regen, no CPU regen
        want = list(host.epoch(epoch, layers=ly))
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            for k in b:
                assert a[k].is_cuda and a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(_as_bits(a[k]), _as_bits(b[k]))
        resumed = list(card.epoch(epoch, start_step=3, layers=ly))
        for a, b in zip(resumed, want[3:]):
            np.testing.assert_array_equal(_as_bits(a["x"]), _as_bits(b["x"]))
    torch.cuda.synchronize()


def _spec_pair(mode):
    """The same spec on 'cuda' and on 'cpu'."""
    kw = dict(LOADER_MODES[mode][0])
    kw.pop("rank")
    out = []
    for b in ("cuda", "cpu"):
        if mode == "plain":
            out.append(PartialShuffleSpec.plain(LN, backend=b, **kw))
        elif mode == "mixture":
            m = PortMixtureSpec(LMIX[0], LMIX[1], **LMIX[2])
            out.append(PartialShuffleSpec.mixture(m, backend=b,
                                                  world=kw["world"]))
        elif mode == "shard":
            out.append(PartialShuffleSpec.shard(
                LSHARDS, window=8, world=kw["world"], backend=b))
        else:
            out.append(StreamSpec.plain_stream(
                kw["horizon"], window=LWIN, world=kw["world"], backend=b))
    return out


@pytest.mark.parametrize("mode", ["plain", "mixture", "shard",
                                  "stream_plain"])
def test_spec_cuda_route_matches_cpu_route(mode):
    card, host = _spec_pair(mode)
    layers = LOADER_MODES[mode][2]
    assert card.fingerprint() == host.fingerprint()
    for rank in range(card.world):
        for ly in (None, layers):
            got = card.rank_indices(3, rank, layers=ly)
            want = host.rank_indices(3, rank, layers=ly)
            assert isinstance(got, np.ndarray) and got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
            units = card.rank_unit_sizes(3, rank, layers=ly)
            if units is not None:
                np.testing.assert_array_equal(
                    units, host.rank_unit_sizes(3, rank, layers=ly))


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_loader_slow_consumer_sees_no_corrupted_batch(depth):
    """Every consumer kernel starts behind a busy-wait and then reads its
    batch: a batch whose memory the allocator handed out again (no
    ``record_stream``) or that the consumer read before its copy landed
    (no event wait) shows as a pattern error."""
    rows = 4096
    data = np.repeat((np.arange(rows, dtype=np.int64) * 7919 % 65_521)
                     [:, None], 512, axis=1).astype(np.int32)
    loader = HostDataLoader(data, window=LWIN, batch=64, world=2, rank=1,
                            depth=depth, index_backend="cuda",
                            device="cuda")
    pattern = torch.from_numpy(data[:, 0]).cuda()
    idx = torch.from_numpy(loader.epoch_indices(0).astype(np.int64)).cuda()
    bad = torch.zeros((), dtype=torch.int64, device="cuda")
    for s, b in enumerate(loader.epoch(0)):
        torch.cuda._sleep(2_000_000)  # ~1 ms: the consumer lags the copies
        want = pattern[idx[s * 64:(s + 1) * 64]][:, None]
        bad += (b != want).sum()
    assert int(bad) == 0
    assert s + 1 == loader.steps_per_epoch


def test_loader_explicit_device_and_own_streams():
    dev = torch.device("cuda", 0)
    loader = _loader("cuda", "cuda:0", window=LWIN, world=2)
    assert loader.device == dev
    b = next(iter(loader.epoch(0)))
    assert b["x"].device == dev and b["t"].device == dev
    list(loader.epoch(1))  # warm: kernels built, tables cached
    # the regen runs on the loader's stream: a consumer stream busy for
    # ~1 s does not hold epoch() back
    torch.cuda._sleep(2_000_000_000)
    import time

    t0 = time.perf_counter()
    loader.clear_cache()
    loader.epoch_indices(5)
    took = time.perf_counter() - t0
    torch.cuda.synchronize()
    assert took < 0.5, took


# ---------------------------------------------------------------- sampling
_SRNG = np.random.default_rng(17)
#: (id, sizes, weights, weight_kind, window, law kwargs): each branch of the
#: alias law (a few columns, 300 columns past the staging cap, a total past
#: 2^31, a source past 2^31 with int64 ids, sources smaller than the window,
#: one-hot and uniform tables, unshuffled, 70 rounds, retry rounds) with
#: negative and 64-bit seeds
WEIGHTED_CASES = [
    ("s3", (900_000, 600_000, 500_000), (5, 1, 2), "per_source", 8192, {}),
    ("s300", tuple(int(x) for x in _SRNG.integers(1, 300_000, 300)),
     tuple(int(x) for x in _SRNG.integers(0, 1000, 300)), "per_sample",
     512, {}),
    ("total64", (5_000_000, 6_000_000), (2**40 + 1, 3**20), "per_source",
     8192, {}),
    ("source64", (2**31 + 7, 1000, 2**32 + 5), (1, 2, 3), "per_source",
     8192, {}),
    ("small-sources", (100, 50, 7000), (3, 3, 1), "per_source", 4096, {}),
    ("one-hot", (3000, 5000, 7000), (0, 4, 0), "per_source", 64, {}),
    ("uniform", (3000, 5000, 7000), (2, 2, 2), "per_source", 64, {}),
    ("unshuffled", (900_000, 600_000), (1, 9), "per_source", 64,
     dict(shuffle=False)),
    ("rounds70", (900_000, 600_000), (1, 9), "per_source", 1000,
     dict(rounds=70)),
    ("retry3", (900_000, 600_000), (1, 9), "per_source", 1000,
     dict(retry=3)),
]


def _weighted_case(cid):
    from partiallyshuffledistributedsampler_tpu_torch.sampling import alias

    _cid, sizes, w, kind, window, law = next(
        c for c in WEIGHTED_CASES if c[0] == cid)
    return alias.build_alias_table(w, kind, sizes), sizes, window, law


@pytest.mark.parametrize("cid", [c[0] for c in WEIGHTED_CASES])
def test_weighted_kernels_match_plain_version(cid):
    table, sizes, window, law = _weighted_case(cid)
    ck.reset_launches()
    runs = 0
    for T, world, partition, drop_last in (
            (1_000_003, 3, "strided", False), (1_000_003, 4, "blocked", True),
            (2**31 + 10, 2**16, "strided", False)):
        wide = core.is_wide(T)
        kernel = ck.weighted_stream_wide if wide else ck.weighted_stream
        ns, _ = core.shard_sizes(T, world, drop_last)
        for rank, seed in ((0, 0), (world - 1, -5), (world // 2, 2**40 + 3)):
            kw = dict(epoch_samples=T, rank=rank, world=world,
                      num_samples=ns, partition=partition, window=window,
                      **law)
            got = kernel(table, sizes, seed, 7, **kw)
            want = ck.weighted_stream_ref(table, sizes, seed, 7,
                                          device="cuda", **kw)
            assert got.is_cuda and got.dtype == want.dtype
            assert torch.equal(got, want), (T, world, rank)
            runs += 1
        # the elastic remainder through the chain table
        layers = [(world * 2, ns // 4)]
        chain, remaining, ns2 = core.elastic_chain(T, layers, world,
                                                   drop_last)
        kw = dict(epoch_samples=T, rank=world - 1, world=world,
                  num_samples=ns2, partition=partition, chain=chain,
                  window=window, **law)
        assert torch.equal(kernel(table, sizes, 3, 1, **kw),
                           ck.weighted_stream_ref(table, sizes, 3, 1,
                                                  device="cuda", **kw))
        runs += 1
    # given ordinals (uint64 bits, negative ones included) on the wide form
    pos = torch.from_numpy(_SRNG.integers(-2**63, 2**63 - 1, 100_000,
                                          dtype=np.int64)).cuda()
    got = ck.weighted_stream_wide(table, sizes, 9, 2, positions=pos,
                                  window=window, **law)
    assert torch.equal(got, ck.weighted_stream_ref(
        table, sizes, 9, 2, positions=pos, window=window, **law))
    runs += 1
    assert sum(ck.launches.values()) == runs


def test_weighted_narrow_and_wide_agree_below_2_32():
    table, sizes, window, _law = _weighted_case("s3")
    ns, _ = core.shard_sizes(1_000_003, 3, False)
    narrow = ck.weighted_stream(table, sizes, 5, 1, epoch_samples=1_000_003,
                                rank=2, world=3, num_samples=ns,
                                window=window)
    pos = core.rank_positions(1_000_003, 2, 3, ns, "strided", False,
                              device="cuda")
    wide = ck.weighted_stream_wide(table, sizes, 5, 1, positions=pos,
                                   window=window)
    assert torch.equal(narrow, wide)


def _sampling_pair(mode, world=3):
    from partiallyshuffledistributedsampler_tpu_torch import SamplingSpec

    sizes = (900_000, 600_000, 500_000)
    out = []
    for b in ("cuda", "cpu"):
        if mode == "weighted":
            s = SamplingSpec.weighted(sizes, (5, 1, 2), epoch_samples=300_001,
                                      window=8192, world=world, backend=b)
        elif mode == "prioritized":
            s = SamplingSpec.prioritized(
                sizes, (1, 1, 1), epoch_samples=300_001, window=8192,
                world=world, backend=b).with_stream_weights({1: (1, 6, 2)})
        else:
            cfg = dict(kind=mode.split("-")[1], retries=3)
            if cfg["kind"] == "bloom":
                cfg.update(bits=1 << 20, hashes=4)
            # 40,000 ids: epochs 0..2 draw 36,000 and never saturate
            s = SamplingSpec.deduped(
                (25_000, 15_000), epoch_samples=12_000, window=512,
                world=world, backend=b, dedup=cfg)
        out.append(s)
    return out


@pytest.mark.parametrize("mode", ["weighted", "prioritized", "dedup-exact",
                                  "dedup-bloom"])
def test_sampling_spec_cuda_matches_cpu(mode):
    card, host = _sampling_pair(mode)
    assert card.fingerprint() == host.fingerprint()
    for epoch in (0, 1, 2):
        for rank in range(card.world):
            for layers in (None, [(2, 40_000 if "dedup" not in mode
                                   else 3000)]):
                ck.reset_launches()
                got = card.rank_indices(epoch, rank, layers=layers)
                n_launch = sum(ck.launches.values())
                want = host.rank_indices(epoch, rank, layers=layers)
                assert isinstance(got, np.ndarray)
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
                if "dedup" not in mode:
                    # one launch a regen, never the plain version
                    assert n_launch == 1
                    assert ck.launches["weighted_stream"] == 1
    if "dedup" in mode:
        # a fresh spec folds epoch 0 with retries + 1 launches
        fresh, _ = _sampling_pair(mode)
        ck.reset_launches()
        fresh.rank_indices(0, 0)
        assert ck.launches["weighted_stream"] == 4
        assert sum(ck.launches.values()) == 4


# ------------------------------------------------ the consumer models
import socket  # noqa: E402

import torch.distributed as dist  # noqa: E402

from partiallyshuffledistributedsampler_tpu_torch import (  # noqa: E402
    MixtureSpec as _MixtureSpec,
    parallel as _parallel,
)
from partiallyshuffledistributedsampler_tpu_torch.models import (  # noqa: E402,E501
    GPTConfig,
    create_state,
    make_mixture_run_runner,
    make_run_runner,
    make_train_step,
)
from partiallyshuffledistributedsampler_tpu_torch.models.train import (  # noqa: E402,E501
    synthetic_tokens,
)

_MINI = dict(vocab_size=64, seq_len=16, d_model=32, n_layers=1, n_heads=2,
             d_ff=64)


@pytest.fixture
def meshes():
    """A process group of one with gloo for CPU tensors and NCCL for CUDA
    ones: the data mesh on the card and on the host."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("cpu:gloo,cuda:nccl",
                            init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        yield (_parallel.data_mesh(device="cuda"),
               _parallel.data_mesh(device="cpu"))
    finally:
        dist.destroy_process_group()


def test_trainer_on_card_matches_cpu_route(meshes):
    """4 f32 steps (TF32 off) on the card against the same steps on the
    host: losses within 1e-4 relative, parameters within 1e-4 (the key
    projection's bias, whose gradient is mathematically zero, within
    2 * lr * steps: see tests/test_torch_port_models.py)."""
    card, host = meshes
    cfg = GPTConfig(dtype=torch.float32, **_MINI)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        tokens = synthetic_tokens(cfg, 256, 5, "cpu")
        runs = []
        for mesh in (card, host):
            model, opt = create_state(cfg, mesh, 3)
            step = make_train_step(cfg, opt, mesh, 4)
            idx = _parallel.sharded_epoch_indices(256, 32, 7, 0, mesh=mesh)
            t = tokens.to(mesh.device_type)
            losses = torch.stack([step(model, t, idx, s) for s in range(4)])
            runs.append((losses.cpu(), {k: v.cpu() for k, v in
                                        model.state_dict().items()}))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    (lc, pc), (lh, ph) = runs
    np.testing.assert_allclose(lc.numpy(), lh.numpy(), rtol=1e-4)
    d = cfg.d_model
    for k, v in pc.items():
        w = ph[k]
        if k.endswith("qkv.bias"):
            np.testing.assert_allclose(v[d:2 * d], w[d:2 * d],
                                       atol=2 * 3e-4 * 4)
            v, w = torch.cat([v[:d], v[2 * d:]]), torch.cat([w[:d],
                                                             w[2 * d:]])
        np.testing.assert_allclose(v.numpy(), w.numpy(), atol=1e-4,
                                   err_msg=k)


def test_runners_make_no_host_sync(meshes):
    """A whole run (bf16) queues its regens and steps without a host
    synchronisation, regenerating with one kernel launch an epoch."""
    card, _host = meshes
    cfg = GPTConfig(**_MINI)
    tokens = synthetic_tokens(cfg, 4096, 1, "cuda")
    spec = _MixtureSpec([2048, 1024, 1024], [70, 20, 10], windows=256)
    model, opt = create_state(cfg, card, 0)
    run = make_run_runner(cfg, opt, card, 8, 4, 3, 4096, 256)
    triple = _parallel.make_seed_triple(0, 0, mesh=card)
    run(model, tokens, triple, 0)  # warm-up: lazy CUDA initialisation
    # made after the warm-up: a fresh spec's tables reach the card when
    # the runner is made, never inside the run
    mix = make_mixture_run_runner(cfg, opt, card, 8, 4, 2, spec)
    torch.cuda.synchronize()
    ck.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses = run(model, tokens, triple, 3)
        mlosses = mix(model, tokens, triple, 3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert ck.launches["index_amortized"] == 3
    assert ck.launches["mixture_fused"] == 2
    assert sum(ck.launches.values()) == 5
    assert losses.shape == (3, 4) and mlosses.shape == (2, 4)
    assert losses.is_cuda and bool(torch.isfinite(losses).all())
    assert bool(torch.isfinite(mlosses).all())


def test_auto_backend_prices_the_card():
    """With a card, 'auto' measures the device line on the port's kernel
    regen and its pinned readback, and the host line on the host backend;
    the single-source sampler keeps the model as ``_auto_cost`` and serves
    the same stream whichever it picks."""
    from partiallyshuffledistributedsampler_tpu_torch.utils import autotune

    model = autotune.cost_model(force=True)
    assert model["host_backend"] in ("native", "cpu")
    assert model["dev_rate_ms"] >= 0 and model["host_rate_ms"] >= 0
    for ns in (1_000, 10_000_000):
        picked, info = autotune.pick_backend(ns)
        assert picked in ("cuda", model["host_backend"])
        assert info["picked"] == picked and info["num_samples"] == ns
    s = PartiallyShuffleDistributedSampler(50_000, num_replicas=4, rank=1,
                                           window=512, backend="auto")
    ref = PartiallyShuffleDistributedSampler(50_000, num_replicas=4, rank=1,
                                             window=512, backend="cpu")
    assert s._auto_cost is not None and s.backend == s._auto_cost["picked"]
    s.set_epoch(2), ref.set_epoch(2)
    assert list(s) == list(ref)
