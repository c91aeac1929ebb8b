"""The elastic remainder (SPEC.md §6) and random access (SPEC.md §4)
through the port's ``index_positions(_wide)`` wrappers on the CPU, where
they run their plain version: held bit-exact (tolerance 0) against the
JAX package's ``elastic_indices_np`` / ``elastic_indices_jax`` and
``stream_indices_at_np`` / ``stream_indices_at_jax``.

Inputs come from numpy seeds.  JAX needs x64 for uint64 positions, which
the conftest does not enable, so the JAX side of the wide cases (n >= 2^31)
runs in one x64 subprocess.  The chain tables the kernels read
(``cuda_kernel.chain_plan``) are held against the plain chain by a
per-lane emulation of the kernel's arithmetic, and their magic numbers
against ``//`` and ``%``.
"""

import json
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from partiallyshuffledistributedsampler_tpu import (
    PartiallyShuffleDistributedSampler as JaxSampler,
)
from partiallyshuffledistributedsampler_tpu.ops import cpu as jcpu
from partiallyshuffledistributedsampler_tpu.ops import mixture as jmix
from partiallyshuffledistributedsampler_tpu.ops import xla
from partiallyshuffledistributedsampler_tpu_torch.ops import (
    core,
    cpu,
    cuda,
    cuda_kernel as ck,
    fastdiv,
)
from partiallyshuffledistributedsampler_tpu_torch.ops import mixture as tmix

TEN_B = 10_000_000_000
N31 = 2**31 - 1  # the largest narrow index space
SEED, EPOCH = 42, 3


def deep_layers(n: int, depth: int, seed: int, worlds=(2, 3, 5, 8)):
    """A reshard cascade of ``depth`` layers from a numpy seed: random
    worlds, each layer consuming 0..2 samples a rank.  ``n`` is the
    domain the first of them partitions."""
    rng = np.random.default_rng(seed)
    layers, domain = [], n
    for _ in range(depth):
        world = int(rng.choice(worlds))
        ns = -(-domain // world)
        consumed = int(rng.integers(0, min(2, ns - 1) + 1))
        layers.append((world, consumed))
        domain = (ns - consumed) * world
    return layers


#: (id, n, window, new world, layers, law kwargs) below 2^31
NARROW = [
    ("strided-1", 100_000, 512, 6, [(8, 3000)], {}),
    ("blocked-1", 100_000, 512, 6, [(8, 3000)], {"partition": "blocked"}),
    ("strided-3-droplast", 100_003, 512, 5, [(8, 3000), (6, 100), (3, 17)],
     {"drop_last": True}),
    ("blocked-3", 100_003, 512, 5, [(8, 3000), (6, 100), (3, 17)],
     {"partition": "blocked"}),
    ("order-windows-off", 50_000, 256, 3, [(4, 2000), (7, 11)],
     {"order_windows": False}),
    ("unshuffled", 50_000, 256, 3, [(4, 2000), (7, 11)], {"shuffle": False}),
    ("rounds0", 50_000, 256, 3, [(4, 2000)], {"rounds": 0}),
    ("rounds102", 50_000, 256, 3, [(4, 2000)], {"rounds": 102}),
    # 1e6 at world 8 leaves 3,000 samples a rank, then 63 small layers
    ("chain64-strided", 1_000_000, 4096, 7,
     [(8, 122_000)] + deep_layers(24_000, 63, 1), {}),
    ("chain64-blocked", 1_000_000, 4096, 7,
     [(8, 122_000)] + deep_layers(24_000, 63, 2), {"partition": "blocked"}),
    # domains grow to 2^32 - 2: the uint32 position math at its edge
    ("near-2^32", N31, 8192, 2**31 - 1,
     [(3, 5), (2**30 + 7, 0), (2**31 - 1, 0)], {}),
    ("near-2^32-blocked", N31, 8192, 2**31 - 1,
     [(3, 5), (2**30 + 7, 0), (2**31 - 1, 0)], {"partition": "blocked"}),
]
#: the same at n >= 2^31 (uint64 positions, int64 indices)
WIDE = [
    ("10B-strided-1", TEN_B, 8192, 4096, [(8192, 1_220_000)], {}),
    ("10B-blocked-3", TEN_B, 8192, 4096,
     [(8192, 1_220_000), (1000, 5000), (4096, 10)], {"partition": "blocked"}),
    ("10B-chain64", TEN_B, 8192, 4096,
     [(8192, 1_220_000)] + deep_layers(5_758_976, 63, 3), {}),
    ("2^31+1-rounds102", 2**31 + 1, 8192, 3, [(2, 2**30 - 1000)],
     {"rounds": 102}),
    ("2^31+1-unshuffled", 2**31 + 1, 8192, 3, [(2, 2**30 - 1000)],
     {"shuffle": False, "partition": "blocked"}),
    ("2^32+4097-droplast-rounds0", 2**32 + 4097, 8192, 16,
     [(2, 2**31 - 1000)], {"drop_last": True, "rounds": 0}),
]
#: random-access probes: ordinary, past one epoch, negative and huge
PROBES = np.concatenate([
    np.arange(4), [-1, -2, -(2**31), -(2**63), 2**63 - 1, 2**32, 2**32 - 1],
    np.random.default_rng(7).integers(-(2**63), 2**63 - 1, 512,
                                      dtype=np.int64),
    np.random.default_rng(8).integers(0, 3 * TEN_B, 512),
]).astype(np.int64)
#: (n, window) of the random-access reads, narrow and wide
STREAM_SPACES = [(100_000, 512), (N31, 8192), (2**31 + 1, 8192),
                 (TEN_B, 8192)]


def _ranks(world: int):
    return sorted({0, world // 2, world - 1})


def _elastic(n, window, world, rank, layers, kw, device="cpu"):
    chain, _remaining, ns = core.elastic_chain(
        n, layers, world, kw.get("drop_last", False))
    law = {k: v for k, v in kw.items() if k != "drop_last"}
    return cuda.elastic_indices_cuda(n, window, SEED, EPOCH, rank, world, ns,
                                     chain, device=device, **law)


_JAX_X64 = textwrap.dedent("""
    import json, os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    import partiallyshuffledistributedsampler_tpu as psds
    psds.enable_big_index_space()
    from partiallyshuffledistributedsampler_tpu.ops import core, xla
    cases, probes, spaces, out = json.loads(sys.argv[1]), sys.argv[2], \\
        json.loads(sys.argv[3]), sys.argv[4]
    seed, epoch = int(sys.argv[5]), int(sys.argv[6])
    rows = {}
    for cid, n, w, world, layers, kw in cases:
        drop = kw.pop("drop_last", False)
        chain, _r, ns = core.elastic_chain(n, layers, world, drop)
        for rank in sorted({0, world // 2, world - 1}):
            rows[f"{cid}/{rank}"] = np.asarray(xla.elastic_indices_jax(
                n, w, seed, epoch, rank, world, ns, chain, **kw))
    p = np.load(probes)
    for n, w in spaces:
        for shuffle in (True, False):
            rows[f"stream/{n}/{shuffle}"] = np.asarray(
                xla.stream_indices_at_jax(p, n, w, seed, epoch,
                                          shuffle=shuffle))
    np.savez(out, **rows)
""")


@pytest.fixture(scope="module")
def jax_x64(tmp_path_factory):
    """The JAX package's wide outputs, from one x64 process."""
    d = tmp_path_factory.mktemp("jax_x64_elastic")
    np.save(d / "probes.npy", PROBES)
    wide_spaces = [s for s in STREAM_SPACES if core.is_wide(s[0])]
    res = subprocess.run(
        [sys.executable, "-c", _JAX_X64,
         json.dumps([[c[0], c[1], c[2], c[3], c[4], dict(c[5])]
                     for c in WIDE]),
         str(d / "probes.npy"), json.dumps(wide_spaces), str(d / "out.npz"),
         str(SEED), str(EPOCH)],
        capture_output=True, text=True, timeout=600,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


# ------------------------------------------------------------ remainder
@pytest.mark.parametrize("cid,n,window,world,layers,kw", NARROW,
                         ids=[c[0] for c in NARROW])
def test_narrow_remainder_matches_numpy_and_jax(cid, n, window, world,
                                                layers, kw):
    chain, _remaining, ns = core.elastic_chain(
        n, layers, world, kw.get("drop_last", False))
    law = {k: v for k, v in kw.items() if k != "drop_last"}
    for rank in _ranks(world):
        got = _elastic(n, window, world, rank, layers, kw)
        assert got.dtype == torch.int32 and got.numel() == ns
        want = jcpu.elastic_indices_np(n, window, SEED, EPOCH, rank, world,
                                       layers, **kw)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            got.numpy(),
            np.asarray(xla.elastic_indices_jax(n, window, SEED, EPOCH, rank,
                                               world, ns, chain, **law)))
        # the wrapper itself, and the CPU backend, give the same
        assert torch.equal(got, ck.index_positions(
            n, window, SEED, EPOCH, rank=rank, world=world, num_samples=ns,
            chain=chain, device="cpu", **law))
        assert torch.equal(got, cpu.elastic_indices_cpu(
            n, window, SEED, EPOCH, rank, world, layers, **kw))


@pytest.mark.parametrize("cid,n,window,world,layers,kw", WIDE,
                         ids=[c[0] for c in WIDE])
def test_wide_remainder_matches_numpy_and_jax(jax_x64, cid, n, window,
                                              world, layers, kw):
    for rank in _ranks(world):
        got = _elastic(n, window, world, rank, layers, kw)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(
            got.numpy(), jcpu.elastic_indices_np(n, window, SEED, EPOCH,
                                                 rank, world, layers, **kw))
        np.testing.assert_array_equal(got.numpy(), jax_x64[f"{cid}/{rank}"])


def test_chain_depth_is_unbounded():
    """A 200-layer cascade, narrow and wide, against the numpy reference."""
    for n, layers in ((1_000_000, [(8, 122_000)]
                       + deep_layers(24_000, 199, 4)),
                      (TEN_B, [(8192, 1_220_000)]
                       + deep_layers(5_758_976, 199, 5))):
        assert len(layers) == 200
        for partition in ("strided", "blocked"):
            kw = {"partition": partition}
            got = _elastic(n, 8192, 7, 6, layers, kw)
            np.testing.assert_array_equal(
                got.numpy(), jcpu.elastic_indices_np(n, 8192, SEED, EPOCH,
                                                     6, 7, layers, **kw))


def _emulate_kernel_chain(words, first, t, rank, world, lanes, strided,
                          bits):
    """Lane t of ``index_positions_kernel``'s chain source, in Python ints:
    the rank position wrapped to ``bits``, then the table's layers with
    every / and % as the kernel computes them, by magic numbers."""
    mask = (1 << bits) - 1

    def quot(x, mult, shift):
        return fastdiv.divide(x, (mult, shift & 0xFF, shift >> 8), bits)

    def rem(x, d, mult, shift):
        return (x - quot(x, mult, shift) * d) & mask

    q = ((rank + world * t) if strided else (rank * lanes + t)) & mask
    q = rem(q, *first)
    for i in range(len(words) // ck.LAYER_WORDS):
        add, ns, gap, g_mult, g_shift, mod, m_mult, m_shift = (
            int(w) for w in words[i * ck.LAYER_WORDS:(i + 1) * ck.LAYER_WORDS])
        if strided:
            q = (q + add) & mask
        else:
            qd = quot(q, g_mult, g_shift)
            q = (qd * ns + add + (q - qd * gap)) & mask
        q = rem(q, mod, m_mult, m_shift)
    return q


@pytest.mark.parametrize("cid,n,window,world,layers,kw",
                         [c for c in NARROW + WIDE
                          if c[0] in ("blocked-3", "chain64-strided",
                                      "chain64-blocked", "near-2^32",
                                      "near-2^32-blocked", "10B-blocked-3",
                                      "10B-chain64")],
                         ids=lambda c: c if isinstance(c, str) else None)
def test_chain_table_drives_the_kernel_arithmetic(cid, n, window, world,
                                                  layers, kw):
    """The table the kernel reads, walked lane by lane as the kernel walks
    it, gives the plain chain's positions (mod n)."""
    partition = kw.get("partition", "strided")
    wide = core.is_wide(n)
    chain, remaining, ns = core.elastic_chain(n, layers, world)
    words, first = ck.chain_plan(n, chain, partition, wide)
    assert first[0] == remaining
    assert words.size == ck.LAYER_WORDS * len(chain)
    for rank in _ranks(world):
        q = core.rank_positions(remaining, rank, world, ns, partition, wide)
        want = core.compose_remainder_chain(q, chain, partition, wide) % n
        t = np.unique(np.concatenate([np.arange(min(ns, 64)),
                                      np.arange(max(ns - 64, 0), ns)]))
        got = [_emulate_kernel_chain(words, first, int(i), rank, world, ns,
                                     partition == "strided",
                                     64 if wide else 32) for i in t]
        assert got == want[torch.from_numpy(t)].tolist()


@pytest.mark.parametrize("wide", [False, True])
def test_magic_numbers_of_every_chain_divisor(wide):
    """Every divisor of the chain tables: ``divide`` by its magic numbers
    equals ``//`` (and so ``%``) at the edges and on seeded numerators of
    the kernel's width."""
    bits = 64 if wide else 32
    mask = (1 << bits) - 1
    rng = np.random.default_rng(11)
    cases = [c for c in (WIDE if wide else NARROW)]
    checked = 0
    for _cid, n, _window, world, layers, kw in cases:
        chain, _r, _ns = core.elastic_chain(n, layers, world,
                                            kw.get("drop_last", False))
        words, first = ck.chain_plan(
            n, chain, kw.get("partition", "strided"), wide)
        divisors = [tuple(first)]
        for i in range(0, words.size, ck.LAYER_WORDS):
            w = [int(v) for v in words[i:i + ck.LAYER_WORDS]]
            divisors += [tuple(w[2:5]), tuple(w[5:8])]
        for d, mult, shift in set(divisors):
            m = (mult, shift & 0xFF, shift >> 8)
            assert m == fastdiv.magic(d, bits)
            xs = {0, 1, d - 1, d, d + 1, 2 * d - 1, mask, mask - 1,
                  mask - d} | {int(x) for x in rng.integers(
                      0, mask, 64, dtype=np.uint64)}
            for x in xs:
                if 0 <= x <= mask:
                    q = fastdiv.divide(x, m, bits)
                    assert (q, x - q * d) == divmod(x, d), (d, x)
            checked += 1
    assert checked > 10


# ---------------------------------------------------------- random access
def test_negative_position_fault_is_repaired():
    """n = 2^31 + 1, p = -1: the reference takes p as uint64 bits, so
    stream(p) = pi((2^64 - 1) mod n) = pi(3)."""
    n = 2**31 + 1
    for fn in (lambda p, **kw: cpu.stream_indices_at_cpu(p, n, 8192, 0, 0,
                                                         **kw),
               lambda p, **kw: cuda.stream_indices_at_cuda(p, n, 8192, 0, 0,
                                                           device="cpu",
                                                           **kw)):
        assert fn([-1], shuffle=False).tolist() == [3]
        np.testing.assert_array_equal(
            fn([-1]).numpy(), jcpu.stream_indices_at_np(np.array([-1]), n,
                                                        8192, 0, 0))
        assert fn([-1]).tolist() == [1910087716]


@pytest.mark.parametrize("n,window", STREAM_SPACES)
def test_stream_at_matches_numpy_and_jax(jax_x64, n, window):
    for shuffle in (True, False):
        want = jcpu.stream_indices_at_np(PROBES, n, window, SEED, EPOCH,
                                         shuffle=shuffle)
        got = cuda.stream_indices_at_cuda(PROBES, n, window, SEED, EPOCH,
                                          shuffle=shuffle, device="cpu")
        assert got.dtype == core.out_dtype(n)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            cpu.stream_indices_at_cpu(PROBES, n, window, SEED, EPOCH,
                                      shuffle=shuffle).numpy(), want)
        jax_want = (jax_x64[f"stream/{n}/{shuffle}"] if core.is_wide(n)
                    else np.asarray(xla.stream_indices_at_jax(
                        PROBES, n, window, SEED, EPOCH, shuffle=shuffle)))
        np.testing.assert_array_equal(got.numpy(), jax_want)


def test_stream_at_keeps_the_positions_shape():
    p = torch.from_numpy(PROBES[:64].reshape(8, 8))
    got = ck.index_positions_wide(TEN_B, 8192, SEED, EPOCH, positions=p,
                                  device="cpu")
    assert got.shape == (8, 8)
    np.testing.assert_array_equal(
        got.numpy().ravel(),
        jcpu.stream_indices_at_np(PROBES[:64], TEN_B, 8192, SEED, EPOCH))


def test_wide_mixture_stream_at_negative_positions():
    """The mixture's uint64 positions take a negative int64 as its bits,
    as the reference casts them (fused, masked and unshuffled routes)."""
    pos = PROBES[:200]
    for sources, weights, block in (([1000, 500, 2500], [5, 1, 4], 100),
                                    ([3_000_000_000, 2_000_000_000], [3, 2],
                                     1024)):
        for pv in (1, 2):
            js = jmix.MixtureSpec(sources, weights, windows=64, block=block,
                                  pattern_version=pv)
            ts = tmix.MixtureSpec(sources, weights, windows=64, block=block,
                                  pattern_version=pv)
            for kw in ({}, {"fused": False}, {"shuffle": False}):
                want = jmix.mixture_stream_at_np(pos, js, 7, 3,
                                                 big_positions=True, **kw)
                got = tmix.mixture_stream_at_cpu(
                    torch.from_numpy(pos), ts, 7, 3, big_positions=True,
                    **kw)
                np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------- refusals
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_same_refusals_on_both_routes(device):
    """What the wrappers refuse, before any device is touched: the same
    error on the plain route and the kernel route."""
    chain, _r, ns = core.elastic_chain(1000, [(2, 10)], 2)
    kw = dict(rank=0, world=2, num_samples=ns, device=device)
    with pytest.raises(ValueError, match="fully consumed"):
        ck.index_positions(1000, 64, 0, 0, chain=((2, 500, 500),), **kw)
    with pytest.raises(ValueError, match="world must be >= 1"):
        ck.index_positions(1000, 64, 0, 0, chain=((0, 500, 10),), **kw)
    with pytest.raises(ValueError, match="empty"):
        ck.index_positions(1000, 64, 0, 0, chain=(), **kw)
    with pytest.raises(ValueError, match="rank"):
        ck.index_positions(1000, 64, 0, 0, chain=chain,
                           **dict(kw, rank=2))
    with pytest.raises(ValueError, match="window"):
        ck.index_positions(1000, 0, 0, 0, chain=chain, **kw)
    with pytest.raises(ValueError, match="partition"):
        ck.index_positions(1000, 64, 0, 0, chain=chain, partition="tiled",
                           **kw)
    with pytest.raises(ValueError, match="wide"):
        ck.index_positions(TEN_B, 64, 0, 0, chain=chain, **kw)
    with pytest.raises(ValueError, match="narrow"):
        ck.index_positions_wide(1000, 64, 0, 0, chain=chain, **kw)
    with pytest.raises(ValueError, match="not both"):
        ck.index_positions(1000, 64, 0, 0, chain=chain,
                           positions=torch.zeros(3, dtype=torch.int64), **kw)
    with pytest.raises(ValueError, match="int64"):
        ck.index_positions(1000, 64, 0, 0, positions=torch.zeros(3),
                           device=device)
    # a domain past 2^32 at n < 2^31: the reference's uint32 casts refuse
    # it too
    huge = [(3, 5), (2**30 + 7, 0), (2**31 - 1, 0), (7, 0)]
    big_chain, _r, big_ns = core.elastic_chain(N31, huge, 2**31 - 1)
    assert big_ns == 3
    with pytest.raises(ValueError, match="does not fit"):
        ck.index_positions(N31, 8192, 0, 0, rank=0, world=2**31 - 1,
                           num_samples=big_ns, chain=big_chain,
                           device=device)
    with pytest.raises(OverflowError):
        jcpu.elastic_indices_np(N31, 8192, 0, 0, 0, 2**31 - 1, huge)


def test_empty_remainder_launches_nothing():
    ck.reset_launches()
    chain, _r, _ns = core.elastic_chain(1000, [(2, 10)], 2)
    got = ck.index_positions(1000, 64, 0, 0, rank=0, world=2, num_samples=0,
                             chain=chain, device="cpu")
    assert got.numel() == 0 and got.dtype == torch.int32
    assert sum(ck.launches.values()) == 0


#: the JAX sampler's checkpoint after a reshard 8 -> 6 at offset 1000,
#: 500 more samples into the remainder (the card tests regenerate it)
JAX_CKPT_ELASTIC = {
    "spec_version": 2, "kind": "single", "seed": 11, "epoch": 2,
    "offset": 500, "n": 100000, "num_replicas": 6, "window": 8192,
    "rounds": 24, "order_windows": True, "partition": "strided",
    "shuffle": True, "drop_last": False, "elastic": {"layers": [[8, 1000]]},
}


def test_jax_elastic_checkpoint_is_the_one_the_card_tests_load():
    js = JaxSampler(100_000, 8, 3, window=8192, seed=11, backend="cpu")
    js.set_epoch(2)
    it = iter(js)
    for _ in range(1000):
        next(it)
    mid = JaxSampler.reshard_from_state_dict(js.state_dict(), 6, 2,
                                             backend="cpu")
    it = iter(mid)
    for _ in range(500):
        next(it)
    assert mid.state_dict() == JAX_CKPT_ELASTIC
