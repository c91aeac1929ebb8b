"""The masked per-source mixture law (SPEC.md §8), the plain version of the
``mixture_fused_wide`` kernel, on the CPU against the JAX package.

``cuda_kernel.mixture_fused_wide_ref`` and the CPU entry points of the
port with ``fused=False`` are held at tolerance 0 (the law is
integer-exact) against the JAX package's numpy law
(``mixture_stream_at_np``, ``mixture_epoch_indices_np``,
``mixture_elastic_indices_np`` with ``fused=False``) on mixtures with a
source of 2^31 or more: shuffled and not, pattern versions 1 and 2, with
and without the window order, strided and blocked, at lanes in and around
each source's tail window and pass wrap, and at positions past 2^32.  A
source costs nothing here while the lanes are few.  The routing: a CPU
device launches no kernel, ``fused=True`` on such a spec raises as in the
JAX package, and on a card a regen picks ``mixture_fused`` or
``mixture_fused_wide``.  The kernel's own source is run on the host by
``tests/test_torch_port_kernel_emulation.py`` and on the card by
``tests/test_torch_port_gpu.py``.

This file imports the JAX package's numpy-only ``ops/mixture.py`` and no
jax, so the card tests can share its specs.
"""

import numpy as np
import pytest
import torch

from partiallyshuffledistributedsampler_tpu.ops import mixture as J
from partiallyshuffledistributedsampler_tpu_torch import (
    MixtureSpec,
    mixture_elastic_indices_cpu,
    mixture_epoch_indices_cpu,
    mixture_stream_at_cpu,
)
from partiallyshuffledistributedsampler_tpu_torch.ops import (
    cuda_kernel as ck,
    mixture as M,
)

#: (id, sources, weights, spec kw): a source just past 2^31 beside a tiny
#: one, a source past 2^32 (the high word of n_s), tail windows of one, and
#: a small spec that mixture_fused takes too
MIX_SPECS = [
    ("past-2^31", (2**31 + 7, 3 * 10**9, 7), (5, 3, 1), {}),
    ("past-2^32", (2**32 + 5, 10**9), (3, 1), {}),
    ("tail-1", (2**31 + 1, 8193, 1000), (6, 3, 1), dict(windows=8192)),
    ("small", (1000, 37, 2500), (5, 1, 4),
     dict(windows=[64, 8, 500], block=100)),
]
WIDE_IDS = ["past-2^31", "past-2^32", "tail-1"]
#: (id, spec kw, law kw) of the law's options
LAWS = [
    ("v2", {}, {}),
    ("v1", dict(pattern_version=1), {}),
    ("unshuffled", {}, dict(shuffle=False)),
    ("unordered", {}, dict(order_windows=False)),
    ("rounds-7", {}, dict(rounds=7)),
]
WORLD = 2**22


def boundary_positions(spec, passes=(0, 1)) -> np.ndarray:
    """Whole blocks of stream positions around each source's tail window
    and its pass wrap, in passes ``passes``: a block holds a source's
    draws j in [blk*k_s, (blk + 1)*k_s) whatever its rotation."""
    B, out = spec.block, []
    for n, w, k in zip(spec.sources, spec.windows, spec.quotas):
        for q in passes:
            for j in (q * n + n // w * w, (q + 1) * n):
                blk = max(j // k - 1, 0)
                out.append(np.arange(blk * B, (blk + 3) * B, dtype=np.int64))
    return np.unique(np.concatenate(out))


def _specs(sid, **extra):
    _sid, sources, weights, skw = next(c for c in MIX_SPECS if c[0] == sid)
    return (J.MixtureSpec(sources, weights, **skw, **extra),
            MixtureSpec(sources, weights, **skw, **extra))


def _law(lid):
    _lid, skw, lkw = next(c for c in LAWS if c[0] == lid)
    return skw, lkw


@pytest.mark.parametrize("lid", [c[0] for c in LAWS])
@pytest.mark.parametrize("sid", WIDE_IDS)
def test_stream_at_tails_and_wraps_match_jax(sid, lid):
    """Random access at every lane of the blocks around each source's tail
    window and pass wrap (positions past 2^32): the plain version of the
    kernel and the routed CPU entry against the JAX package's masked
    loop."""
    skw, lkw = _law(lid)
    js, ps = _specs(sid, **skw)
    pos = np.concatenate([boundary_positions(ps),
                          [2**32 - 1, 2**32, 2**33 + 5, 10**10 + 3]])
    want = J.mixture_stream_at_np(pos, js, 2**40 + 9, 3, fused=False, **lkw)
    assert want.dtype == np.int64
    got = ck.mixture_fused_wide_ref(None, ps, 2**40 + 9, 3,
                                    positions=torch.from_numpy(pos),
                                    wide_pos=True, device="cpu", **lkw)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    for fused in (False, None):
        np.testing.assert_array_equal(
            mixture_stream_at_cpu(pos, ps, 2**40 + 9, 3, fused=fused,
                                  **lkw).numpy(), want)
    # lanes in each source's tail window did come up
    s, _pas, u = M.lane_draws(torch.from_numpy(pos), ps, 2**40 + 9, 3,
                              shuffle=lkw.get("shuffle", True), wide=True)
    for src, (n, w) in enumerate(zip(ps.sources, ps.windows)):
        if n % w:
            assert bool(((s == src) & (u >= n // w * w)).any()), src


@pytest.mark.parametrize("sid", ["past-2^31", "tail-1"])
def test_stream_at_uint32_positions_match_jax(sid):
    """Positions below 2^31 take uint32 arithmetic on both sides."""
    js, ps = _specs(sid)
    pos = np.concatenate([
        np.random.default_rng(5).integers(0, 2**31 - 2 * ps.block, 3000),
        boundary_positions(ps, passes=(0,))])
    pos = pos[pos < 2**31 - 2 * ps.block]
    want = J.mixture_stream_at_np(pos, js, 7, 1, fused=False)
    got = ck.mixture_fused_wide_ref(None, ps, 7, 1,
                                    positions=torch.from_numpy(pos),
                                    wide_pos=False, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        mixture_stream_at_cpu(pos, ps, 7, 1, big_positions=False).numpy(),
        want)


@pytest.mark.parametrize("partition", ["strided", "blocked"])
@pytest.mark.parametrize("lid", [c[0] for c in LAWS])
@pytest.mark.parametrize("sid", WIDE_IDS)
def test_epoch_indices_match_jax(sid, lid, partition):
    """A rank's epoch at world 2^22 (uint64 positions, every pass), first
    and last rank: the kernel's plain version in its rank form and the CPU
    entry, against ``mixture_epoch_indices_np``."""
    skw, lkw = _law(lid)
    js, ps = _specs(sid, **skw)
    _t, ns, total = M.mixture_epoch_sizes(ps, None, WORLD, False)
    for rank in (0, WORLD - 1):
        want = J.mixture_epoch_indices_np(js, 11, 2, rank, WORLD,
                                          partition=partition, fused=False,
                                          **lkw)
        got = ck.mixture_fused_wide_ref(
            None, ps, 11, 2, rank=rank, world=WORLD, num_samples=ns,
            partition=partition, wide_pos=total + ps.block > 2**31 - 1,
            device="cpu", **lkw)
        np.testing.assert_array_equal(got.numpy(), want)
        for kw in (dict(fused=False), dict(fused=False, amortize=False), {}):
            np.testing.assert_array_equal(
                mixture_epoch_indices_cpu(ps, 11, 2, rank, WORLD,
                                          partition=partition, **lkw,
                                          **kw).numpy(), want)


@pytest.mark.parametrize("sid", ["past-2^31", "tail-1"])
def test_short_epoch_uint32_positions_match_jax(sid):
    """An epoch of 5,000 samples over a wide spec: uint32 positions,
    int64 ids."""
    js, ps = _specs(sid)
    for rank, partition in ((0, "strided"), (2, "blocked")):
        want = J.mixture_epoch_indices_np(js, 3, 9, rank, 3,
                                          epoch_samples=5000,
                                          partition=partition, fused=False)
        got = mixture_epoch_indices_cpu(ps, 3, 9, rank, 3,
                                        epoch_samples=5000,
                                        partition=partition, fused=False)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("partition", ["strided", "blocked"])
@pytest.mark.parametrize("sid", WIDE_IDS)
def test_elastic_remainder_matches_jax(sid, partition):
    """The remainder after a reshard 2^21 -> 2^22 and a 2-layer cascade."""
    js, ps = _specs(sid)
    for layers in ([(WORLD // 2, 300)], [(WORLD // 2, 200), (WORLD, 100)]):
        for rank in (0, 5, WORLD - 1):
            want = J.mixture_elastic_indices_np(js, 5, 1, rank, WORLD,
                                                layers, partition=partition,
                                                fused=False)
            got = mixture_elastic_indices_cpu(ps, 5, 1, rank, WORLD, layers,
                                              partition=partition,
                                              fused=False)
            np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_entries_launch_no_kernel():
    _js, ps = _specs("past-2^31")
    ck.reset_launches()
    mixture_epoch_indices_cpu(ps, 1, 1, 0, WORLD)
    mixture_epoch_indices_cpu(ps, 1, 1, 0, WORLD, fused=False)
    mixture_stream_at_cpu(np.arange(100), ps, 1, 1, fused=False)
    mixture_elastic_indices_cpu(ps, 1, 1, 0, WORLD, [(WORLD // 2, 300)])
    ck.mixture_fused_wide(None, ps, 1, 1, positions=torch.arange(100),
                          wide_pos=False, device="cpu")
    assert not any(ck.launches.values())


@pytest.mark.parametrize("sid", WIDE_IDS)
def test_fused_true_on_a_wide_spec_raises_as_in_jax(sid):
    js, ps = _specs(sid)
    with pytest.raises(ValueError, match="fused evaluation"):
        J.mixture_epoch_indices_np(js, 1, 1, 0, WORLD, fused=True)
    with pytest.raises(ValueError, match="fused evaluation"):
        mixture_epoch_indices_cpu(ps, 1, 1, 0, WORLD, fused=True)
    with pytest.raises(ValueError, match="fused evaluation"):
        mixture_stream_at_cpu(np.arange(10), ps, 1, 1, fused=True)


#: (spec id, fused, shuffle) -> the wrapper a regen on the card launches
ROUTES = [
    ("small", None, True, "mixture_fused"),
    ("small", None, False, "mixture_fused"),
    ("small", True, True, "mixture_fused"),
    ("small", False, True, "mixture_fused_wide"),
    ("small", False, False, "mixture_fused_wide"),
    ("past-2^31", None, True, "mixture_fused_wide"),
    ("past-2^31", None, False, "mixture_fused_wide"),
    ("past-2^31", False, True, "mixture_fused_wide"),
    ("past-2^32", None, True, "mixture_fused_wide"),
    ("tail-1", False, False, "mixture_fused_wide"),
]


@pytest.mark.parametrize("sid,fused,shuffle,name", ROUTES)
def test_card_route(sid, fused, shuffle, name, monkeypatch):
    """On a CUDA device every regen launches a mixture kernel: never the
    plain law."""
    monkeypatch.setattr(ck, "device_kind", lambda device: "cuda")
    _js, ps = _specs(sid)
    assert M._kernel_route(ps, "cuda", fused, shuffle) is getattr(ck, name)


@pytest.mark.parametrize("sid,shuffle", [("past-2^31", True),
                                         ("small", False)])
def test_card_route_refuses_fused_true_where_it_does_not_apply(
        sid, shuffle, monkeypatch):
    monkeypatch.setattr(ck, "device_kind", lambda device: "cuda")
    _js, ps = _specs(sid)
    with pytest.raises(ValueError, match="fused evaluation"):
        M._kernel_route(ps, "cuda", True, shuffle)


def test_wide_kernel_refuses_what_its_table_cannot_carry(monkeypatch):
    """A window of 2^31 or more, or 2^31 windows or more, does not fit the
    kernel's 32-bit source table: the wrapper raises (the plain law raises
    too where it shuffles)."""
    monkeypatch.setattr(ck, "device_kind", lambda device: "cuda")
    for windows in ([2**31, 1000], [1, 1000]):
        ps = MixtureSpec([3 * 10**9, 1000], [3, 1], windows=windows)
        with pytest.raises(ValueError, match="2\\^31"):
            ck.mixture_fused_wide(None, ps, 1, 1, positions=torch.arange(4),
                                  wide_pos=False)
        with pytest.raises(ValueError, match="2\\^31"):
            mixture_stream_at_cpu(np.arange(4), ps, 1, 1)
