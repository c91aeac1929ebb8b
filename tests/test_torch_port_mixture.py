"""The port's weighted mixture (SPEC.md §8) on the CPU against the JAX
package: ``MixtureSpec`` tables and errors, the mixture law through every
evaluator of the port (the fused per-lane one, the kernel's plain version,
the masked per-source loop with and without its amortized tables), random
access, elastic remainders, the mixture sampler with checkpoints carried
across packages, and ``MixtureEpochIterator`` / ``run_epoch`` /
``run_epochs`` step sequences.  Tolerance 0 everywhere: the law is
integer-exact.  The kernels themselves are tested on the card by
``tests/test_torch_port_gpu.py``.
"""

import numpy as np
import pytest
import torch
from torch.utils.data import DataLoader

import jax.numpy as jnp

from partiallyshuffledistributedsampler_tpu.ops import mixture as J
from partiallyshuffledistributedsampler_tpu.sampler.jax_iterator import (
    DeviceEpochIterator as JaxDeviceEpochIterator,
    MixtureEpochIterator as JaxMixtureEpochIterator,
)
from partiallyshuffledistributedsampler_tpu.sampler.mixture import (
    PartialShuffleMixtureSampler as JaxMixtureSampler,
)
from partiallyshuffledistributedsampler_tpu_torch import (
    CudaUnavailableError,
    DeviceEpochIterator,
    MixtureEpochIterator,
    MixtureSpec,
    PartialShuffleMixtureSampler,
    mixture_elastic_indices_cpu,
    mixture_elastic_indices_cuda,
    mixture_epoch_indices_cpu,
    mixture_epoch_indices_cuda,
    mixture_stream_at_cpu,
    mixture_stream_at_cuda,
)
from partiallyshuffledistributedsampler_tpu_torch.ops import (
    core,
    cuda_kernel as ck,
    mixture as M,
)

#: the constants of tests/test_mixture.py
SIZES, WEIGHTS = [1000, 500, 2500], [5, 1, 4]


def _specs(sizes, weights, **kw):
    return (J.MixtureSpec(sizes, weights, **kw),
            MixtureSpec(sizes, weights, **kw))


# ------------------------------------------------------------ the spec
SPEC_GRID = [
    (SIZES, WEIGHTS, dict(windows=64, block=100)),
    (SIZES, WEIGHTS, dict(windows=[64, 1000, 7], block=16,
                          pattern_version=1)),
    ([700, 200, 100], [70, 20, 10], dict(windows=8192)),
    ([5], [1], dict(windows=2, block=3)),
    (list(range(100, 109)), [1, 2, 3, 4, 5, 6, 7, 8, 9], dict(block=45)),
    ([10**9, 3, 2**31 + 7], [1000, 1, 500], dict(windows=4096, block=1501)),
]


@pytest.mark.parametrize("sizes,weights,kw", SPEC_GRID)
def test_spec_tables_match_jax(sizes, weights, kw):
    js, ps = _specs(sizes, weights, **kw)
    for f in ("sources", "weights", "windows", "block", "pattern_version",
              "quotas", "bases", "total_sources_len", "num_sources"):
        assert getattr(ps, f) == getattr(js, f), f
    np.testing.assert_array_equal(ps.pattern, js.pattern)
    np.testing.assert_array_equal(ps.prefix, js.prefix)
    assert ps.key() == js.key() and MixtureSpec.from_key(ps.key()).key() \
        == ps.key()
    for shuffle in (True, False):
        assert ps.rotated(shuffle) == js.rotated(shuffle)
    for world in (1, 4, 6):
        np.testing.assert_array_equal(ps.rank_slot_counts(1 % world, world),
                                      js.rank_slot_counts(1 % world, world))
    ids = np.arange(0, ps.total_sources_len, max(1, ps.total_sources_len
                                                 // 97))
    for a, b in zip(ps.decompose(ids), js.decompose(ids)):
        np.testing.assert_array_equal(a, b)
    assert ps.out_dtype() == (torch.int32 if ps.total_sources_len < 2**31
                              else torch.int64)


BAD_SPECS = [
    ([], [], {}),
    ([5, 5], [1], {}),
    ([5, 0], [1, 1], {}),
    ([5, 5], [1, 0], {}),
    ([5, 5], [1, 1], dict(windows=[1, 2, 3])),
    ([5, 5], [1, 1], dict(windows=[1, 0])),
    ([5, 5], [1, 1], dict(pattern_version=3)),
    ([5, 5, 5], [1, 1, 1], dict(block=2)),
    ([5, 5], [1, 1000], dict(block=10)),
]


@pytest.mark.parametrize("sizes,weights,kw", BAD_SPECS)
def test_spec_errors_match_jax(sizes, weights, kw):
    with pytest.raises(ValueError) as want:
        J.MixtureSpec(sizes, weights, **kw)
    with pytest.raises(ValueError) as got:
        MixtureSpec(sizes, weights, **kw)
    assert str(got.value) == str(want.value)


def test_balance_warnings_match_jax():
    js, ps = _specs(SIZES, WEIGHTS, windows=64, block=100,
                    pattern_version=1)
    for check in ("check_rank_balance", "check_world_balance"):
        args = (0, 50, "strided") if check == "check_rank_balance" \
            else (50, "strided")
        with pytest.warns(UserWarning) as want:
            getattr(js, check)(*args)
        with pytest.warns(UserWarning) as got:
            getattr(ps, check)(*args)
        assert str(got[0].message) == str(want[0].message)


# ------------------------------------------------------- the law, numpy
#: (sizes, weights, spec kw, law kw, world): S in {1, 3, 9}, pattern v1/v2,
#: shuffle, order_windows, strided/blocked, drop_last, epoch_samples None /
#: below T / several passes, block {16, 100, 1024}, with and without tails
LAW_GRID = [
    (SIZES, WEIGHTS, dict(windows=64, block=100), {}, 1),
    (SIZES, WEIGHTS, dict(windows=64, block=100), {}, 3),
    (SIZES, WEIGHTS, dict(windows=64, block=100, pattern_version=1), {}, 2),
    (SIZES, WEIGHTS, dict(windows=64, block=100),
     dict(partition="blocked"), 3),
    (SIZES, WEIGHTS, dict(windows=64, block=100), dict(shuffle=False), 2),
    (SIZES, WEIGHTS, dict(windows=64, block=100, pattern_version=1),
     dict(shuffle=False, partition="blocked"), 3),
    (SIZES, WEIGHTS, dict(windows=64, block=100), dict(order_windows=False),
     8),
    (SIZES, WEIGHTS, dict(windows=64, block=100), dict(drop_last=True), 3),
    (SIZES, WEIGHTS, dict(windows=64, block=16), dict(epoch_samples=777), 2),
    (SIZES, WEIGHTS, dict(windows=[64, 500, 100], block=1024),
     dict(epoch_samples=20_000), 8),
    ([4096, 512], [1, 1], dict(windows=256, block=16), {}, 2),  # no tails
    ([3001], [7], dict(windows=97, block=16), dict(epoch_samples=9000), 3),
    (list(range(300, 309)), [1, 2, 3, 4, 5, 6, 7, 8, 9],
     dict(windows=32, block=100), dict(epoch_samples=6000), 3),
    (list(range(300, 309)), [9, 8, 7, 6, 5, 4, 3, 2, 1],
     dict(windows=1, block=1024, pattern_version=1),
     dict(partition="blocked", epoch_samples=3000), 8),
    (SIZES, WEIGHTS, dict(windows=64, block=100), dict(rounds=5), 2),
]


def _law_id(case):
    sizes, _w, skw, lkw, world = case
    return f"S{len(sizes)}-{skw}-{lkw}-w{world}".replace(" ", "")


@pytest.mark.parametrize("case", LAW_GRID, ids=_law_id)
def test_epoch_indices_match_numpy_reference(case):
    sizes, weights, skw, lkw, world = case
    js, ps = _specs(sizes, weights, **skw)
    for rank in sorted({0, world - 1}):
        want = J.mixture_epoch_indices_np(js, 11, 2, rank, world, **lkw)
        for kw in (dict(), dict(fused=False), dict(fused=False,
                                                   amortize=False)):
            got = mixture_epoch_indices_cpu(ps, 11, 2, rank, world, **lkw,
                                            **kw)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("pattern_version,lkw,world", [
    (2, {}, 3), (1, {}, 2), (2, dict(partition="blocked"), 2),
    (2, dict(epoch_samples=9000, order_windows=False), 4),
])
def test_epoch_indices_match_jax_entry(pattern_version, lkw, world):
    js, ps = _specs(SIZES, WEIGHTS, windows=64, block=100,
                    pattern_version=pattern_version)
    for rank in (0, world - 1):
        want = np.asarray(J.mixture_epoch_indices_jax(js, 5, 1, rank, world,
                                                      **lkw))
        got = mixture_epoch_indices_cpu(ps, 5, 1, rank, world, **lkw)
        np.testing.assert_array_equal(got.numpy(), want)


def test_fused_and_masked_evaluators_agree_with_jax():
    """The port's fused evaluator, its masked loop (amortized and per
    lane) and the kernel's plain version, against the JAX package's fused
    and masked evaluators."""
    js, ps = _specs([1000, 37, 2500, 64], [5, 1, 4, 2], windows=[64, 8, 500,
                                                                 64],
                    block=100)
    want = J.mixture_epoch_indices_np(js, 9, 4, 1, 3, epoch_samples=12_000)
    np.testing.assert_array_equal(
        J.mixture_epoch_indices_np(js, 9, 4, 1, 3, epoch_samples=12_000,
                                   fused=False), want)
    for kw in (dict(fused=True), dict(fused=False),
               dict(fused=False, amortize=False)):
        got = M.mixture_epoch_indices_generic(ps, 9, 4, 1, 3,
                                              epoch_samples=12_000, **kw)
        np.testing.assert_array_equal(got.numpy(), want)
    _t, ns, _total = M.mixture_epoch_sizes(ps, 12_000, 3, False)
    keys = ck.mixture_source_keys(ps, 9, 4, device="cpu")
    got = ck.mixture_fused(keys, ps, 9, 4, rank=1, world=3, num_samples=ns,
                           wide_pos=False)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="fused evaluation"):
        mixture_epoch_indices_cpu(ps, 9, 4, 1, 3, shuffle=False, fused=True)


def test_golden_mixture_frozen():
    """The constants of tests/test_mixture.py::test_golden_mixture_frozen,
    through the port, both pattern versions."""
    spec1 = MixtureSpec(SIZES, WEIGHTS, windows=64, block=100,
                        pattern_version=1)
    assert spec1.pattern[:10].tolist() == [0, 2, 0, 2, 0, 1, 2, 0, 2, 0]
    ids1 = mixture_epoch_indices_cpu(spec1, 7, 3, 0, 1)
    assert ids1[:8].tolist() == [394, 2255, 425, 2252, 411, 1363, 2260, 402]
    assert int(ids1.sum()) == 5793243
    spec2 = MixtureSpec(SIZES, WEIGHTS, windows=64, block=100)
    ids2 = mixture_epoch_indices_cpu(spec2, 7, 3, 0, 1)
    assert ids2[:8].tolist() == [2255, 394, 2252, 425, 1363, 2260, 411, 2262]
    assert int(ids2.sum()) == 5793243


# --------------------------------------------------- wide positions, ids
def test_uint64_positions_few_lanes():
    """epoch_samples = 2^31 + 5000 at world 2^20: ~2,049 lanes a rank,
    positions past 2^31 (uint64), int32 ids."""
    js, ps = _specs([700_000, 200_000, 100_000], [70, 20, 10], windows=8192)
    world = 2**20
    for rank in (0, 777_777, world - 1):
        want = J.mixture_epoch_indices_np(js, 3, 1, rank, world,
                                          epoch_samples=2**31 + 5000)
        got = mixture_epoch_indices_cpu(ps, 3, 1, rank, world,
                                        epoch_samples=2**31 + 5000)
        assert got.dtype == torch.int32 and got.numel() == 2049
        np.testing.assert_array_equal(got.numpy(), want)


#: config 5's 10B id space as a 70/20/10 mixture (M3), and a mixture with a
#: source >= 2^31, which takes the masked evaluator
WIDE_SPECS = [
    ([1_750_000_000] * 4 + [2_000_000_000, 1_000_000_000],
     [175] * 4 + [200, 100]),
    ([3_000_000_000, 1_000_000_000], [3, 1]),
]


@pytest.mark.parametrize("sizes,weights", WIDE_SPECS)
def test_int64_ids_at_sampled_ranks(sizes, weights):
    js, ps = _specs(sizes, weights, windows=8192)
    world = 2**22
    _t, ns, _total = M.mixture_epoch_sizes(ps, None, world, False)
    for rank in (0, 3_000_001, world - 1):
        pos = rank + world * np.arange(ns, dtype=np.int64)
        want = J.mixture_stream_at_np(pos, js, 5, 2)
        got = mixture_epoch_indices_cpu(ps, 5, 2, rank, world)
        assert got.dtype == torch.int64 and want.dtype == np.int64
        np.testing.assert_array_equal(got.numpy(), want)
        assert int(got.max()) > 2**31
    assert ps.fused_applies() == (max(sizes) < 2**31)


def test_stream_at_random_positions():
    js, ps = _specs(SIZES, WEIGHTS, windows=64, block=100)
    pos = np.random.default_rng(0).integers(0, 3 * 10**6, 4096)
    for kw in (dict(), dict(shuffle=False), dict(fused=False)):
        np.testing.assert_array_equal(
            mixture_stream_at_cpu(pos, ps, 5, 1, **kw).numpy(),
            J.mixture_stream_at_np(pos, js, 5, 1, **kw))
    big = np.array([0, 2**31 - 1, 2**31, 2**32 + 5, 10**10 + 3])
    np.testing.assert_array_equal(mixture_stream_at_cpu(big, ps, 5, 1).numpy(),
                                  J.mixture_stream_at_np(big, js, 5, 1))


@pytest.mark.parametrize("layers,partition,world", [
    ([(3, 400)], "strided", 2),
    ([(4, 100), (3, 7)], "strided", 3),
    ([(2, 900)], "blocked", 4),
    ([(2, 2000)], "strided", 2),  # fully consumed: an empty remainder
])
def test_elastic_matches_numpy_reference(layers, partition, world):
    js, ps = _specs(SIZES, WEIGHTS, windows=64, block=100)
    for rank in range(world):
        want = J.mixture_elastic_indices_np(js, 5, 1, rank, world, layers,
                                            partition=partition)
        got = mixture_elastic_indices_cpu(ps, 5, 1, rank, world, layers,
                                          partition=partition)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------- the kernels' plain
def test_source_keys_plain_version_layout():
    """The keys buffer: rk, the epoch, then per source its seed key and the
    pairing constants of its outer, inner and tail bijections."""
    ps = MixtureSpec([1000, 37, 2500], [5, 1, 4], windows=[64, 8, 500],
                     block=100)
    rounds = 6
    keys = ck.mixture_source_keys(ps, (1 << 40) + 9, 4, rounds=rounds,
                                  device="cpu").numpy().view(np.uint32)
    assert keys.shape == (ck.mixture_key_words(ps, rounds),)
    assert keys[0] == M.rotation_key((1 << 40) + 9, 4) and keys[1] == 4
    for s, (n, w) in enumerate(zip(ps.sources, ps.windows)):
        row = keys[2 + s * (1 + 3 * rounds):][:1 + 3 * rounds]
        lo, hi = M.source_seed_folded((1 << 40) + 9, s)
        ek0 = core.derive_epoch_key((lo, hi), 4)
        assert row[0] == core.mix32(core.mix32(lo ^ core._GOLDEN)
                                    ^ core.mix32(hi ^ core._C_SEED_HI))
        for i, (pair, m) in enumerate((
                (core.outer_key(ek0), n // w),
                (core.inner_pair_key(ek0), w),
                (core.tail_key(ek0), n % w))):
            sched = row[1 + i * rounds:1 + (i + 1) * rounds].tolist()
            assert sched == (core.round_keys(pair, m, rounds) if m > 1
                             else [0] * rounds)


def test_fused_plain_version_positions_form():
    js, ps = _specs(SIZES, WEIGHTS, windows=64, block=100)
    pos = torch.from_numpy(np.random.default_rng(2).integers(0, 10**6, 999))
    keys = ck.mixture_source_keys(ps, 1, 2, device="cpu")
    got = ck.mixture_fused(keys, ps, 1, 2, positions=pos, wide_pos=False)
    np.testing.assert_array_equal(got.numpy(),
                                  J.mixture_stream_at_np(pos.numpy(), js, 1,
                                                         2))
    with pytest.raises(ValueError, match="not both"):
        ck.mixture_fused(keys, ps, 1, 2, positions=pos, rank=0,
                         wide_pos=False)
    with pytest.raises(ValueError, match="pass positions"):
        ck.mixture_fused(keys, ps, 1, 2, rank=0, wide_pos=False)


def test_triple_drives_the_law_on_the_cpu():
    ps = MixtureSpec(SIZES, WEIGHTS, windows=64, block=100)
    bits = np.array(core.seed_triple((1 << 40) + 5, 6), dtype=np.uint32)
    t = torch.from_numpy(bits.view(np.int32))
    want = mixture_epoch_indices_cpu(ps, (1 << 40) + 5, 6, 1, 3)
    for fused in (None, False):
        got = mixture_epoch_indices_cuda(ps, None, None, 1, 3, device="cpu",
                                         triple=t, fused=fused)
        assert torch.equal(got, want)
    assert torch.equal(
        ck.mixture_source_keys(ps, None, None, device="cpu", triple=t),
        ck.mixture_source_keys(ps, (1 << 40) + 5, 6, device="cpu"))
    assert torch.equal(
        mixture_elastic_indices_cuda(ps, None, None, 0, 2, [(3, 50)],
                                     device="cpu", triple=t),
        mixture_elastic_indices_cpu(ps, (1 << 40) + 5, 6, 0, 2, [(3, 50)]))


def test_cpu_routing_launches_no_mixture_kernel():
    ck.reset_launches()
    ps = MixtureSpec(SIZES, WEIGHTS, windows=64, block=100)
    mixture_epoch_indices_cpu(ps, 0, 0, 0, 2)
    mixture_stream_at_cpu(np.arange(10), ps, 0, 0)
    mixture_elastic_indices_cpu(ps, 0, 0, 0, 2, [(3, 10)])
    assert not any(ck.launches.values())


# ---------------------------------------------------------- the sampler
def _samplers(**kw):
    kw = dict(dict(num_replicas=3, rank=1, windows=64, block=100, seed=4),
              **kw)
    return (JaxMixtureSampler(SIZES, WEIGHTS, backend="cpu", **kw),
            PartialShuffleMixtureSampler(SIZES, WEIGHTS, backend="cpu", **kw))


@pytest.mark.parametrize("kw", [{}, dict(partition="blocked"),
                                dict(epoch_samples=3000, drop_last=True),
                                dict(shuffle=False, pattern_version=1)])
def test_sampler_stream_matches_jax_sampler(kw):
    js, ps = _samplers(**kw)
    for e in (0, 2):
        js.set_epoch(e)
        ps.set_epoch(e)
        assert len(ps) == len(js)
        assert list(ps) == list(js)
        np.testing.assert_array_equal(ps.epoch_indices(), js.epoch_indices())
    ids = np.asarray(ps.epoch_indices())
    for a, b in zip(ps.decompose(ids), js.decompose(ids)):
        np.testing.assert_array_equal(a, b)
    assert ps.regen_timer.report()


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_checkpoints_carry_across_packages(direction):
    """Mid-epoch and mid-remainder checkpoints resume in the other
    package's sampler, and resharding resumes there too."""
    js, ps = _samplers()
    src, dst_cls = (ps, JaxMixtureSampler) if direction == "port_to_jax" \
        else (js, PartialShuffleMixtureSampler)
    src.set_epoch(3)
    full = list(src)
    it = iter(src)
    head = [next(it) for _ in range(123)]
    state = src.state_dict()
    assert head == full[:123] and state["offset"] == 123
    dst = dst_cls(SIZES, WEIGHTS, num_replicas=3, rank=1, windows=64,
                  block=100, backend="cpu")
    dst.load_state_dict(state)
    assert len(dst) == len(full) - 123 and list(dst) == full[123:]
    # reshard 3 -> 2, then a checkpoint mid-remainder, then resume it
    r_src = type(src).reshard_from_state_dict(state, 2, 1, backend="cpu")
    r_dst = dst_cls.reshard_from_state_dict(state, 2, 1, backend="cpu")
    rem = list(r_src)
    assert list(r_dst) == rem
    it = iter(r_src)
    [next(it) for _ in range(40)]
    mid = r_src.state_dict()
    assert mid["elastic"]["layers"] == [[3, 123]]
    back = dst_cls(SIZES, WEIGHTS, num_replicas=2, rank=1, windows=64,
                   block=100, backend="cpu")
    back.load_state_dict(mid)
    assert list(back) == rem[40:]
    # a cascade: reshard the mid-remainder checkpoint 2 -> 4
    deeper = [list(dst_cls.reshard_from_state_dict(mid, 4, r,
                                                   backend="cpu"))
              for r in range(4)]
    want = [list(JaxMixtureSampler.reshard_from_state_dict(mid, 4, r,
                                                           backend="cpu"))
            for r in range(4)]
    assert deeper == want


def test_v1_checkpoint_defaults_and_validation():
    js, ps = _samplers(pattern_version=1)
    state = js.state_dict()
    del state["pattern_version"]  # a v1 build wrote none
    ps.load_state_dict(state)
    _js2, ps2 = _samplers()
    with pytest.raises(ValueError, match="pattern_version=1"):
        ps2.load_state_dict(state)
    r = PartialShuffleMixtureSampler.reshard_from_state_dict(state, 2, 0,
                                                             backend="cpu")
    assert r.spec.pattern_version == 1
    good = ps.state_dict()
    for field, bad in (("sources", [1, 2, 3]), ("weights", [1, 1, 1]),
                       ("windows", [8, 8, 8]), ("block", 50),
                       ("num_replicas", 5), ("epoch_samples", 99),
                       ("offset", 10**9)):
        with pytest.raises(ValueError):
            ps.load_state_dict(dict(good, **{field: bad}))
    for kind in ("single", None):
        with pytest.raises(ValueError, match="kind"):
            ps.load_state_dict(dict(good, kind=kind))
        with pytest.raises(ValueError, match="kind"):
            PartialShuffleMixtureSampler.reshard_from_state_dict(
                dict(good, kind=kind), 2, 0, backend="cpu")
    with pytest.raises(ValueError, match="'seed'"):
        ps.load_state_dict({k: v for k, v in good.items() if k != "seed"})
    with pytest.raises(ValueError, match="spec version"):
        ps.load_state_dict(dict(good, spec_version=99))
    with pytest.raises(ValueError, match="cannot be reproduced"):
        PartialShuffleMixtureSampler.reshard_from_state_dict(
            dict(good, windows=[64, 64, 5000]), 2, 0, backend="cpu")


def test_sampler_validation_errors():
    for kw, match in ((dict(rank=3), "rank"), (dict(partition="x"),
                                               "partition"),
                      (dict(backend="xla"), "JAX package"),
                      (dict(backend="tpu"), "'cpu', 'native' or 'cuda'"),
                      (dict(epoch_samples=0), "epoch_samples")):
        args = dict(dict(num_replicas=3, rank=1, backend="cpu"), **kw)
        with pytest.raises(ValueError, match=match):
            PartialShuffleMixtureSampler(SIZES, WEIGHTS, **args)
    with pytest.warns(UserWarning, match="NEVER"):
        PartialShuffleMixtureSampler(SIZES, WEIGHTS, num_replicas=50,
                                     rank=0, block=100, pattern_version=1,
                                     backend="cpu")


def test_sampler_through_a_dataloader():
    sampler = PartialShuffleMixtureSampler(
        [range(1000), range(500), range(2500)], WEIGHTS, num_replicas=2,
        rank=1, windows=64, block=100, backend="cpu")
    sampler.set_epoch(1)
    want = mixture_epoch_indices_cpu(sampler.spec, 0, 1, 1, 2)
    ds = list(range(sampler.spec.total_sources_len))
    for workers in (0, 2):
        got = torch.cat(list(DataLoader(ds, batch_size=256, sampler=sampler,
                                        num_workers=workers)))
        assert torch.equal(got, want.to(got.dtype))


# ---------------------------------------------- iterators and runners
def _jax_step(c, b):
    return c + b.sum(), b.sum()


def _port_step(c, b):
    return c + b.sum(), b.sum()


def _jax_carry(c, b):
    return c + b.sum()


def _port_carry(c, b):
    return c + b.sum()


def _iterators(**kw):
    js, ps = _specs(SIZES, WEIGHTS, windows=64, block=100)
    return (JaxMixtureEpochIterator(js, 64, seed=3, rank=1, world=2, **kw),
            MixtureEpochIterator(ps, 64, seed=3, rank=1, world=2,
                                 device="cpu", **kw))


def test_mixture_iterator_serves_the_stream():
    ji, pi = _iterators(drop_last_batch=False)
    assert pi.windows == ji.windows and pi.steps_per_epoch == \
        ji.steps_per_epoch
    with pytest.raises(AttributeError, match="no single window"):
        pi.window
    with pytest.raises(AttributeError, match="no single window"):
        pi.window = 5
    for e in (0, 1):
        got = list(pi.epoch(e))
        want = [np.asarray(b) for b in ji.epoch(e)]
        assert [b.numel() for b in got] == [b.size for b in want]
        np.testing.assert_array_equal(torch.cat(got).numpy(),
                                      np.concatenate(want))
        assert e + 1 in pi._cache
    for layers in ([(3, 200)], [(4, 300), (3, 7)]):
        np.testing.assert_array_equal(
            pi.elastic_epoch_array(2, layers).numpy(),
            np.asarray(ji.elastic_epoch_array(2, layers)))
    with pytest.raises(TypeError, match="MixtureSpec"):
        MixtureEpochIterator(object(), 64, device="cpu")


@pytest.mark.parametrize("kw,run", [
    ({}, dict(collect=True)),
    ({}, dict(steps=5, collect=True)),
    (dict(drop_last_batch=False), dict(on_tail="run")),
    (dict(drop_last_batch=False), dict(on_tail="drop", collect=True)),
])
def test_run_epoch_and_run_epochs_match_jax(kw, run):
    ji, pi = _iterators(**kw)
    collect = run.get("collect", False)
    jstep, pstep = ((_jax_step, _port_step) if collect
                    else (_jax_carry, _port_carry))
    jout = ji.run_epoch(3, jstep, jnp.int32(0), **run)
    pout = pi.run_epoch(3, pstep, torch.tensor(0), **run)
    assert 4 in pi._cache  # the next epoch was prefetched
    run.pop("steps", None)
    jmany = ji.run_epochs(3, 2, jstep, jnp.int32(0), **run)
    pmany = pi.run_epochs(3, 2, pstep, torch.tensor(0), **run)
    for j, p in ((jout, pout), (jmany, pmany)):
        if collect:
            assert int(j[0]) == int(p[0])
            np.testing.assert_array_equal(np.asarray(j[1]), p[1].numpy())
        else:
            assert int(j) == int(p)


def test_runner_contract_errors_match_jax():
    ji, pi = _iterators(drop_last_batch=False)
    for call in (
            dict(),  # on_tail='error' with a tail
            dict(on_tail="bogus"),
            dict(on_tail="run", collect=True),
            dict(on_tail="run", steps=3),
            dict(on_tail="drop", steps=10**6),
            dict(on_tail="drop", steps=0)):
        with pytest.raises(ValueError) as want:
            ji.run_epoch(0, _jax_carry, jnp.int32(0), **call)
        with pytest.raises(ValueError) as got:
            pi.run_epoch(0, _port_carry, torch.tensor(0), **call)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="n_epochs"):
        pi.run_epochs(0, 0, _port_carry, torch.tensor(0), on_tail="drop")
    assert not pi._cache  # nothing was regenerated by a refused call


def test_single_source_runners_match_jax():
    ji = JaxDeviceEpochIterator(5000, 512, 100, seed=2, rank=1, world=3,
                                drop_last_batch=False)
    pi = DeviceEpochIterator(5000, 512, 100, seed=2, rank=1, world=3,
                             drop_last_batch=False, device="cpu")
    assert int(ji.run_epoch(1, _jax_carry, jnp.int32(0), on_tail="run")) \
        == int(pi.run_epoch(1, _port_carry, torch.tensor(0), on_tail="run"))
    jc, jy = ji.run_epochs(1, 3, _jax_step, jnp.int32(0), collect=True,
                           on_tail="drop")
    pc, py = pi.run_epochs(1, 3, _port_step, torch.tensor(0), collect=True,
                           on_tail="drop")
    assert int(jc) == int(pc) and py.shape == (3, 16)
    np.testing.assert_array_equal(np.asarray(jy), py.numpy())


def test_run_epochs_regenerates_through_the_entry_once_per_epoch(
        monkeypatch):
    """``run_epochs`` regenerates each epoch once, through
    ``mixture_epoch_indices_cuda`` (the kernels on the card), never from
    the iterator's cache."""
    from partiallyshuffledistributedsampler_tpu_torch.sampler import (
        device_iterator,
    )

    calls = []
    real = device_iterator.mixture_epoch_indices_cuda

    def spy(*args, **kw):
        calls.append(args[2])
        return real(*args, **kw)

    monkeypatch.setattr(device_iterator, "mixture_epoch_indices_cuda", spy)
    _ji, pi = _iterators()
    pi.run_epochs(4, 3, _port_carry, torch.tensor(0))
    assert calls == [4, 5, 6]


# ------------------------------------------------------------ refusals
@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the CPU-only refusals do not apply")


def test_every_cuda_entry_raises_without_gpu(no_gpu):
    ps = MixtureSpec(SIZES, WEIGHTS, windows=64, block=100)
    calls = [
        lambda: mixture_epoch_indices_cuda(ps, 0, 0, 0, 2),
        lambda: mixture_epoch_indices_cuda(ps, 0, 0, 0, 2, fused=False),
        lambda: mixture_stream_at_cuda(np.arange(5), ps, 0, 0),
        lambda: mixture_elastic_indices_cuda(ps, 0, 0, 0, 2, [(3, 10)]),
        lambda: ck.mixture_source_keys(ps, 0, 0),
        lambda: PartialShuffleMixtureSampler(SIZES, WEIGHTS, num_replicas=2,
                                             rank=0),
        lambda: MixtureEpochIterator(ps, 64),
    ]
    for call in calls:
        with pytest.raises(CudaUnavailableError):
            call()
