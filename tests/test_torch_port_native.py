"""The port's native C++ host kernel (``ops/native.py`` over its own copy
``csrc/host/psds_core.cpp``) against the JAX package's numpy reference and
the port's CPU route, tolerance 0 (the law is integer-exact), for all five
entry points at the parametrisations of ``tests/test_native.py``; the
samplers, the spec and ``HostDataLoader`` on 'native' and 'auto'; and the
build's failure modes, which raise rather than serve another route."""

import ctypes
import os
import pathlib

import numpy as np
import pytest
import torch

from partiallyshuffledistributedsampler_tpu.ops import cpu as jcpu
from partiallyshuffledistributedsampler_tpu.ops import mixture as JM
from partiallyshuffledistributedsampler_tpu.sampler.shard_mode import (
    expand_shard_indices_np,
)
from partiallyshuffledistributedsampler_tpu.service import (
    PartialShuffleSpec as JaxSpec,
)
from partiallyshuffledistributedsampler_tpu_torch import (
    HostDataLoader,
    MixtureSpec,
    PartialShuffleMixtureSampler,
    PartialShuffleShardSampler,
    PartialShuffleSpec,
    PartiallyShuffleDistributedSampler,
    ensure_index_backend,
    epoch_indices_cpu,
    mixture_elastic_indices_cpu,
    mixture_epoch_indices_cpu,
    mixture_stream_at_cpu,
)
from partiallyshuffledistributedsampler_tpu_torch.ops import (
    native,
    resolve_host_backend,
)
from partiallyshuffledistributedsampler_tpu_torch.sampler.shard_mode import (
    expand_shard_indices_cpu,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "partiallyshuffledistributedsampler_tpu_torch"


@pytest.fixture(scope="module", autouse=True)
def built():
    """The port's copy builds with g++ into its own build directory."""
    so = native.build()
    assert pathlib.Path(so).parent == PORT / "csrc" / "build"
    assert native.available()


CONFIGS = [
    dict(n=50_000, window=512, world=2),
    dict(n=12_345, window=512, world=8),
    dict(n=1000, window=1, world=3),
    dict(n=1000, window=2048, world=3),
    dict(n=97, window=10, world=3, partition="blocked"),
    dict(n=5000, window=100, world=4, order_windows=False),
    dict(n=777, window=33, world=5, shuffle=False),
    dict(n=640, window=64, world=8, drop_last=True),
]


@pytest.mark.parametrize("cfg", CONFIGS,
                         ids=lambda c: f"n{c['n']}w{c['window']}x{c['world']}")
@pytest.mark.parametrize("seed,epoch", [(0, 0), ((1 << 40) + 5, 7)])
def test_epoch_indices_bit_identical(cfg, seed, epoch):
    cfg = dict(cfg)
    n, w, world = cfg.pop("n"), cfg.pop("window"), cfg.pop("world")
    for rank in range(0, world, max(1, world // 3)):
        ref = jcpu.epoch_indices_np(n, w, seed, epoch, rank, world, **cfg)
        got = native.epoch_indices_native(n, w, seed, epoch, rank, world,
                                          **cfg)
        port = epoch_indices_cpu(n, w, seed, epoch, rank, world,
                                 **cfg).numpy()
        assert got.dtype == ref.dtype == port.dtype
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, port)


def test_int64_space():
    n, world = 10_000_000_000, 2_000_000
    ref = jcpu.epoch_indices_np(n, 8192, 9, 1, 7, world)
    got = native.epoch_indices_native(n, 8192, 9, 1, 7, world)
    port = epoch_indices_cpu(n, 8192, 9, 1, 7, world).numpy()
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, port)


def test_validates():
    with pytest.raises(ValueError, match="rank"):
        native.epoch_indices_native(10, 4, 0, 0, 9, 4)
    with pytest.raises(ValueError, match="rounds"):
        native.epoch_indices_native(10, 4, 0, 0, 0, 4, rounds=65)
    with pytest.raises(ValueError, match="partition"):
        native.epoch_indices_native(10, 4, 0, 0, 0, 4, partition="x")


MIX_CASES = [
    ([1000, 500, 2500], [5, 1, 4], 64, 100),
    ([7, 1000, 13], [1, 5, 2], [7, 64, 13], 50),
    ([97, 31], [3, 1], 10, 16),
    ([5, 2000], [1, 9], 1, 100),
    ([1], [1], 1, 4),
]
MIX_KW = ({}, {"partition": "blocked"}, {"epoch_samples": 7777},
          {"order_windows": False}, {"shuffle": False}, {"drop_last": True})


@pytest.mark.parametrize("case", range(len(MIX_CASES)))
@pytest.mark.parametrize("pv", [1, 2])
def test_mixture_bit_identical(case, pv):
    sizes, weights, windows, block = MIX_CASES[case]
    jspec = JM.MixtureSpec(sizes, weights, windows=windows, block=block,
                           pattern_version=pv)
    spec = MixtureSpec(sizes, weights, windows=windows, block=block,
                       pattern_version=pv)
    checked = 0
    for kw in MIX_KW:
        for rank, world in [(0, 1), (2, 4)]:
            try:
                ref = JM.mixture_epoch_indices_np(jspec, 12345678901, 3,
                                                  rank, world, **kw)
            except ValueError:
                continue  # an invalid combination (drop_last n < world)
            got = native.mixture_epoch_indices_native(spec, 12345678901, 3,
                                                      rank, world, **kw)
            port = mixture_epoch_indices_cpu(spec, 12345678901, 3, rank,
                                             world, **kw).numpy()
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got, ref)
            np.testing.assert_array_equal(got, port)
            checked += 1
    assert checked >= 10


def test_mixture_golden():
    for pv, head in ((1, [394, 2255, 425, 2252, 411, 1363, 2260, 402]),
                     (2, [2255, 394, 2252, 425, 1363, 2260, 411, 2262])):
        spec = MixtureSpec([1000, 500, 2500], [5, 1, 4], windows=64,
                           block=100, pattern_version=pv)
        ids = native.mixture_epoch_indices_native(spec, 7, 3, 0, 1)
        assert ids[:8].tolist() == head


@pytest.mark.parametrize("pv", [1, 2])
def test_mixture_stream_at_and_elastic(pv):
    args = ([1000, 500, 2500], [5, 1, 4])
    jspec = JM.MixtureSpec(*args, windows=64, block=100, pattern_version=pv)
    spec = MixtureSpec(*args, windows=64, block=100, pattern_version=pv)
    rng = np.random.default_rng(0)
    pos = np.concatenate([np.arange(2000), rng.integers(0, 50_000, 300)])
    got = native.mixture_stream_at_native(pos, spec, 12345678901, 3)
    np.testing.assert_array_equal(
        got, JM.mixture_stream_at_np(pos, jspec, 12345678901, 3))
    np.testing.assert_array_equal(got, mixture_stream_at_cpu(
        torch.from_numpy(pos), spec, 12345678901, 3).numpy())
    p2 = pos[:12].reshape(3, 4)  # multi-dim positions keep their shape
    got2 = native.mixture_stream_at_native(p2, spec, 12345678901, 3)
    assert got2.shape == (3, 4)
    np.testing.assert_array_equal(
        got2, JM.mixture_stream_at_np(p2, jspec, 12345678901, 3))
    with pytest.raises(ValueError, match=">= 0"):
        native.mixture_stream_at_native([-1], spec, 0, 0)
    for layers in ([(4, 100)], [(4, 100), (3, 50)], [(2, 2000)]):
        got = native.mixture_elastic_indices_native(spec, 7, 3, 1, 2, layers)
        np.testing.assert_array_equal(got, JM.mixture_elastic_indices_np(
            jspec, 7, 3, 1, 2, layers))
        np.testing.assert_array_equal(got, mixture_elastic_indices_cpu(
            spec, 7, 3, 1, 2, layers).numpy())


@pytest.mark.parametrize("wss", [True, False, 0, 3, 64, 5000, 2**32])
def test_shard_expansion_bit_identical(wss):
    rng = np.random.default_rng(7)
    sizes = np.concatenate([rng.integers(0, 400, 300), [0, 1, 2],
                            rng.integers(200, 2000, 200)])
    sid = rng.permutation(len(sizes))[:400]
    got = native.expand_shard_indices_native(sid, sizes, seed=5, epoch=2,
                                             within_shard_shuffle=wss)
    np.testing.assert_array_equal(got, expand_shard_indices_np(
        sid, sizes, seed=5, epoch=2, within_shard_shuffle=wss))
    np.testing.assert_array_equal(got, expand_shard_indices_cpu(
        sid, sizes, seed=5, epoch=2, within_shard_shuffle=wss).numpy())


def test_shard_expansion_edges():
    sizes = np.asarray([3, 0, 5])
    assert len(native.expand_shard_indices_native([], sizes)) == 0
    for bad in ([-1], [len(sizes)]):
        with pytest.raises(ValueError, match="shard ids"):
            native.expand_shard_indices_native(bad, sizes)
    with pytest.raises(ValueError, match="within_shard_shuffle"):
        native.expand_shard_indices_native([0], sizes,
                                           within_shard_shuffle=-2)


def test_batch_chunk_boundaries():
    """Windows and shard sizes past the kernel's 8,192-entry run buffer:
    the chunk continuation must stitch bit-identically."""
    for world, part in [(1, "strided"), (3, "strided"), (2, "blocked")]:
        for rank in range(world):
            got = native.epoch_indices_native(100_000, 20_000, 42, 5, rank,
                                              world, partition=part)
            np.testing.assert_array_equal(got, jcpu.epoch_indices_np(
                100_000, 20_000, 42, 5, rank, world, partition=part))
            np.testing.assert_array_equal(got, epoch_indices_cpu(
                100_000, 20_000, 42, 5, rank, world,
                partition=part).numpy())
    sizes = np.asarray([30_000, 500, 9_500])
    for wss in (True, 9000):
        got = native.expand_shard_indices_native(
            [2, 0, 1, 0], sizes, seed=3, epoch=1, within_shard_shuffle=wss)
        np.testing.assert_array_equal(got, expand_shard_indices_np(
            [2, 0, 1, 0], sizes, seed=3, epoch=1, within_shard_shuffle=wss))
        np.testing.assert_array_equal(got, expand_shard_indices_cpu(
            [2, 0, 1, 0], sizes, seed=3, epoch=1,
            within_shard_shuffle=wss).numpy())


# ------------------------------------------------ the surfaces on 'native'
@pytest.mark.parametrize("backend", ["native", "auto"])
def test_single_source_sampler(backend):
    kw = dict(num_replicas=3, rank=1, window=64, seed=11)
    s = PartiallyShuffleDistributedSampler(5000, backend=backend, **kw)
    ref = PartiallyShuffleDistributedSampler(5000, backend="cpu", **kw)
    assert s.backend == "native"  # no card: 'auto' is the host backend
    assert s._auto_cost is None
    s.set_epoch(2), ref.set_epoch(2)
    assert list(s) == list(ref)
    state = s.state_dict(consumed=100)
    re = PartiallyShuffleDistributedSampler.reshard_from_state_dict(
        state, num_replicas=2, rank=0, backend=backend)
    re_ref = PartiallyShuffleDistributedSampler.reshard_from_state_dict(
        state, num_replicas=2, rank=0, backend="cpu")
    assert list(re) == list(re_ref)


@pytest.mark.parametrize("backend", ["native", "auto"])
def test_mixture_sampler(backend):
    kw = dict(num_replicas=2, rank=1, windows=64, block=100)
    a = PartialShuffleMixtureSampler([1000, 500, 2500], [5, 1, 4],
                                     backend=backend, **kw)
    b = PartialShuffleMixtureSampler([1000, 500, 2500], [5, 1, 4],
                                     backend="cpu", **kw)
    assert a.backend == "native"
    a.set_epoch(3), b.set_epoch(3)
    assert list(a) == list(b)
    state = a.state_dict(consumed=40)
    c = PartialShuffleMixtureSampler([1000, 500, 2500], [5, 1, 4],
                                     backend=backend, **kw)
    c.load_state_dict(state)
    assert list(c) == list(b)[40:]
    nat = PartialShuffleMixtureSampler.reshard_from_state_dict(
        state, num_replicas=3, rank=0, backend=backend)
    ref = PartialShuffleMixtureSampler.reshard_from_state_dict(
        state, num_replicas=3, rank=0, backend="cpu")
    assert list(nat) == list(ref)


def test_shard_sampler():
    sizes = np.random.default_rng(5).integers(1, 50, 300)
    a = PartialShuffleShardSampler(300, num_replicas=4, rank=2,
                                   backend="native")
    b = PartialShuffleShardSampler(300, num_replicas=4, rank=2,
                                   backend="cpu")
    a.set_epoch(1), b.set_epoch(1)
    assert list(a) == list(b)
    for wss in (True, 8, False):
        got = a.device_epoch_indices(sizes, within_shard_shuffle=wss)
        assert got.device.type == "cpu"
        assert torch.equal(got, b.device_epoch_indices(
            sizes, within_shard_shuffle=wss))


def _spec_pairs():
    sizes = np.random.default_rng(2).integers(5, 60, 200)
    mix = ([1000, 500, 2500], [5, 1, 4], [64, 64, 64], 100, 2)
    return [
        ("plain", dict(n=10_000, window=128), None),
        ("plain", dict(n=10_000, window=128), [(3, 1000)]),
        ("mixture", dict(mixture_key=mix, epoch_samples=3000), None),
        ("mixture", dict(mixture_key=mix), [(3, 300)]),
        ("shard", dict(shard_sizes=sizes, window=16), None),
        ("shard", dict(shard_sizes=sizes, window=16,
                       within_shard_shuffle=4), [(4, 10)]),
    ]


@pytest.mark.parametrize("case", range(6))
@pytest.mark.parametrize("backend", ["native", "auto"])
def test_spec(case, backend):
    mode, kw, layers = _spec_pairs()[case]
    spec = PartialShuffleSpec(mode, seed=5, world=2, backend=backend, **kw)
    jspec = JaxSpec(mode, seed=5, world=2, backend="cpu", **kw)
    assert spec.backend == "native"
    assert spec.fingerprint() == jspec.fingerprint()
    for rank in (0, 1):
        got = spec.rank_indices(3, rank, layers=layers)
        ref = jspec.rank_indices(3, rank, layers=layers)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("mode", ["plain", "mixture", "shard"])
@pytest.mark.parametrize("backend", ["native", "auto"])
def test_host_loader(mode, backend):
    rng = np.random.default_rng(3)
    if mode == "mixture":
        spec = MixtureSpec([200, 100, 300], [3, 1, 2], windows=16, block=30)
        X, kw = np.arange(spec.total_sources_len), dict(mixture=spec)
    elif mode == "shard":
        sizes = rng.integers(50, 200, 120)
        X = np.arange(int(sizes.sum()))
        kw = dict(window=16, shard_sizes=sizes)
    else:
        X, kw = np.arange(4000), dict(window=64)
    kw.update(batch=32, world=2, rank=1, seed=5, device="cpu")
    a = HostDataLoader(X, index_backend=backend, **kw)
    b = HostDataLoader(X, index_backend="cpu", **kw)
    assert a.index_backend == "native" and a._auto_cost is None
    layers = [(3, 20)] if mode != "shard" else None
    for e_kw in ({}, {"layers": layers} if layers else {}):
        got = [x.clone() for x in a.epoch(1, **e_kw)]
        ref = list(b.epoch(1, **e_kw))
        assert len(got) == len(ref) > 0
        for x, y in zip(got, ref):
            assert torch.equal(x, y)


EXIT_MID_EPOCH = """
import sys
import numpy as np
from partiallyshuffledistributedsampler_tpu_torch import HostDataLoader
from partiallyshuffledistributedsampler_tpu_torch.service.spec import (
    MixtureSpec)
if sys.argv[2] == "mixture":
    spec = MixtureSpec([200_000, 100_000, 300_000], [3, 1, 2], windows=16,
                       block=30)
    X, kw = np.arange(spec.total_sources_len), dict(mixture=spec)
else:
    X, kw = np.arange(2_000_000), dict(window=64)
ld = HostDataLoader(X, index_backend=sys.argv[1], batch=32, world=2,
                    rank=1, seed=5, device="cpu", **kw)
next(ld.epoch(1))
print("left mid-epoch")
"""


@pytest.mark.parametrize("mode", ["plain", "mixture"])
@pytest.mark.parametrize("backend", ["native", "auto", "cpu"])
def test_host_loader_exit_with_boundary_worker_in_flight(mode, backend):
    """A process that leaves mid-epoch, while the boundary worker is still
    regenerating the next epoch, exits cleanly: the interpreter waits for
    the worker (it aborted while a daemon worker was inside torch ops),
    and the abandoned epoch's generator retires quietly at exit."""
    import subprocess
    import sys

    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", EXIT_MID_EPOCH, backend,
                          mode], capture_output=True, text=True,
                         timeout=120, cwd=str(ROOT), env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == "left mid-epoch"
    assert res.stderr == ""


def test_host_loader_close_waits_for_the_boundary_worker():
    """``close()`` joins the boundary worker and drops the caches; the
    loader then serves the next epoch from a foreground regen."""
    X = np.arange(40_000)
    kw = dict(window=64, batch=32, world=2, rank=1, seed=5, device="cpu")
    a = HostDataLoader(X, index_backend="native", **kw)
    b = HostDataLoader(X, index_backend="cpu", boundary_prefetch=False, **kw)
    first = next(a.epoch(1))
    worker = a._boundary_thread
    assert worker is not None and not worker.daemon
    a.close()
    assert not worker.is_alive() and a._boundary_thread is None
    assert a._boundary_box is None and a._idx_cache is None
    assert torch.equal(first, next(b.epoch(1)))
    for x, y in zip(a.epoch(2), b.epoch(2)):
        assert torch.equal(x, y)


def test_auto_rule_without_a_card():
    """No card: every surface resolves 'auto' host-side and no device
    probe runs (the cost model is None)."""
    from partiallyshuffledistributedsampler_tpu_torch.utils import autotune

    assert not torch.cuda.is_available()
    assert autotune.cost_model() is None
    assert autotune.pick_backend(10**6) == ("native", None)
    assert resolve_host_backend() == "native"


# ------------------------------------------------- the build's failures
def test_corrupt_source_raises(monkeypatch, tmp_path):
    """A source that does not compile raises at construction on 'native';
    only 'auto' resolves to the CPU route, by its rule."""
    bad = tmp_path / "psds_core.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SOURCE", str(bad))
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="native build failed"):
        native.build()
    with pytest.raises(RuntimeError, match="native build failed"):
        ensure_index_backend("native")
    with pytest.raises(RuntimeError, match="native build failed"):
        PartiallyShuffleDistributedSampler(100, 2, 0, backend="native")
    with pytest.raises(RuntimeError, match="native build failed"):
        PartialShuffleSpec.plain(100, window=8, backend="native")
    assert not native.available()
    assert resolve_host_backend() == "cpu"
    assert PartialShuffleSpec.plain(100, window=8,
                                    backend="auto").backend == "cpu"


def test_corrupt_library_raises(monkeypatch, tmp_path):
    """A library file that does not load raises; it is never replaced by
    another route."""
    src = tmp_path / "psds_core.cpp"
    src.write_bytes(pathlib.Path(native._SOURCE).read_bytes())
    monkeypatch.setattr(native, "_SOURCE", str(src))
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    os.makedirs(tmp_path / "build")
    pathlib.Path(native.library_path()).write_bytes(b"\x7fELF garbage")
    with pytest.raises(RuntimeError, match="does not load"):
        native.epoch_indices_native(100, 8, 0, 0, 0, 1)
    with pytest.raises(RuntimeError, match="does not load"):
        PartialShuffleMixtureSampler([10, 20], [1, 1], num_replicas=1,
                                     rank=0, backend="native")


def test_never_opens_the_repo_root_library(monkeypatch):
    """The port loads only its own build, never the JAX package's
    ``csrc/libpsds_core.so``."""
    opened = []
    real = ctypes.CDLL

    def spy(path, *a, **k):
        opened.append(os.path.realpath(path))
        return real(path, *a, **k)

    monkeypatch.setattr(native.ctypes, "CDLL", spy)
    monkeypatch.setattr(native, "_lib", None)
    native.epoch_indices_native(100, 8, 0, 0, 0, 1)
    assert len(opened) == 1
    build_dir = os.path.realpath(PORT / "csrc" / "build")
    assert opened[0].startswith(build_dir + os.sep)
    assert opened[0] != os.path.realpath(ROOT / "csrc" / "libpsds_core.so")
    assert "libpsds_core.so" not in (PORT / "ops" / "native.py").read_text()
