"""The port's ``HostDataLoader`` on the CPU (``index_backend="cpu"``,
``device="cpu"``) against the JAX package's ``HostDataLoader`` (CPU JAX),
batch by batch, over the cases of ``tests/test_host_loader.py``: prefetch
depths, dict and single-array data, the tail batch, ``start_step``
resumes, the §8 mixture in concatenated and per-source form with
``epoch_samples``, the §7 shard mode, §6 elastic ``layers``, streaming
horizons, early exits, gather errors, the index cache, the boundary
prefetch, the watchdog and the construction refusals.  Tolerance 0.  The
card's route (pinned gathers, copy stream, events) is held against this
one by ``tests/test_torch_port_gpu.py``.
"""

import threading

import numpy as np
import pytest
import torch

from partiallyshuffledistributedsampler_tpu.ops import mixture as JM
from partiallyshuffledistributedsampler_tpu.sampler import (
    HostDataLoader as JLoader,
)
from partiallyshuffledistributedsampler_tpu_torch import (
    CudaUnavailableError,
    HostDataLoader,
    MixtureSpec,
    StallError,
    StallProbe,
)

#: the constants of tests/test_host_loader.py
N, WINDOW, BATCH, WORLD = 530, 32, 64, 2
MIX = ([200, 100, 300], [3, 1, 2], dict(windows=16, block=30))
SHARD_SIZES = np.random.default_rng(3).integers(8, 20, 40)


def _data():
    return {"x": np.arange(N * 3).reshape(N, 3), "y": np.arange(N)}


def _pair(data, **kw):
    """The same loader in both packages: (jax, port)."""
    kw.setdefault("batch", BATCH)
    jkw, pkw = dict(kw), dict(kw)
    if kw.get("mixture") == "mix":
        jkw["mixture"] = JM.MixtureSpec(MIX[0], MIX[1], **MIX[2])
        pkw["mixture"] = MixtureSpec(MIX[0], MIX[1], **MIX[2])
    return (JLoader(data, index_backend="cpu", **jkw),
            HostDataLoader(data, index_backend="cpu", device="cpu", **pkw))


def _host(b):
    if isinstance(b, dict):
        return {k: np.asarray(v) for k, v in b.items()}
    return np.asarray(b)


def _assert_same(jit, pit):
    jb = [_host(b) for b in jit]
    pb = list(pit)
    assert len(jb) == len(pb)
    for a, b in zip(jb, pb):
        if isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                assert isinstance(b[k], torch.Tensor) and b[k].device.type == "cpu"
                np.testing.assert_array_equal(b[k].numpy(), a[k])
        else:
            assert isinstance(b, torch.Tensor)
            np.testing.assert_array_equal(b.numpy(), a)
    return pb


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_batches_match_jax_loader(depth):
    j, p = _pair(_data(), window=WINDOW, world=WORLD, depth=depth)
    assert p.steps_per_epoch == j.steps_per_epoch
    _assert_same(j.epoch(2), p.epoch(2))


@pytest.mark.parametrize("rank", [0, 1])
def test_single_array_and_tail_batch(rank):
    X = np.arange(N, dtype=np.int32)
    for drop in (True, False):
        j, p = _pair(X, window=WINDOW, world=WORLD, rank=rank,
                     drop_last_batch=drop)
        got = _assert_same(j.epoch(1), p.epoch(1))
        if not drop:
            assert len(got[-1]) == p.num_samples % BATCH  # the short tail


def test_start_step_resume():
    j, p = _pair(_data(), window=WINDOW, world=WORLD)
    for start in (0, 2, p.steps_per_epoch):
        _assert_same(j.epoch(3, start_step=start), p.epoch(3, start_step=start))


@pytest.mark.parametrize("law", [dict(partition="blocked"),
                                 dict(drop_last=True, seed=11),
                                 dict(order_windows=False, rounds=5),
                                 dict(shuffle=False)])
def test_law_kwargs_pass_through(law):
    j, p = _pair(np.arange(N), window=WINDOW, world=3, rank=2, **law)
    _assert_same(j.epoch(4), p.epoch(4))


def test_uint16_token_rows():
    rows = np.arange(N * 8, dtype=np.uint16).reshape(N, 8) * np.uint16(97)
    j, p = _pair(rows, window=WINDOW, world=WORLD)
    got = _assert_same(j.epoch(0), p.epoch(0))
    assert got[0].dtype == torch.uint16


@pytest.mark.parametrize("rank", [0, 1])
def test_mixture_concatenated_and_per_source(rank):
    total = sum(MIX[0])
    X = np.arange(total * 2).reshape(total, 2)
    parts = np.split(X, np.cumsum(MIX[0])[:-1])
    kw = dict(batch=32, world=2, rank=rank, mixture="mix")
    for data in ({"x": X}, [{"x": q} for q in parts], list(parts)):
        j, p = _pair(data, **kw)
        _assert_same(j.epoch(4), p.epoch(4))
        _assert_same(j.epoch(1, layers=[(3, 40)]),
                     p.epoch(1, layers=[(3, 40)]))


def test_mixture_epoch_samples():
    X = np.arange(sum(MIX[0]))
    j, p = _pair(X, batch=25, mixture="mix", epoch_samples=700)
    _assert_same(j.epoch(0), p.epoch(0))


@pytest.mark.parametrize("wss", [True, False, 3])
def test_shard_mode(wss):
    X = np.arange(int(SHARD_SIZES.sum()))
    j, p = _pair(X, batch=16, world=2, rank=1, window=8, seed=5,
                 shard_sizes=SHARD_SIZES, within_shard_shuffle=wss)
    assert p.steps_per_epoch is None
    assert p.epoch_steps(2) == j.epoch_steps(2)
    _assert_same(j.epoch(2), p.epoch(2))
    _assert_same(j.epoch(2, start_step=3), p.epoch(2, start_step=3))
    _assert_same(j.epoch(2, layers=[(3, 4)]), p.epoch(2, layers=[(3, 4)]))


def test_elastic_layers():
    j, p = _pair(_data(), window=WINDOW, world=WORLD)
    for layers in ([(3, 40)], [(3, 40), (5, 7)]):
        assert p.epoch_steps(1, layers) == j.epoch_steps(1, layers)
        _assert_same(j.epoch(1, layers=layers), p.epoch(1, layers=layers))


def test_streaming_horizons_plain_and_mixture():
    data = np.arange(256)
    j, p = _pair(data, streaming=True, horizon=64, window=8, batch=16)
    assert p.stream_spec.mode == "stream"
    assert p.stream_spec.fingerprint() == j.stream_spec.fingerprint()
    for g in range(3):
        idx = p.epoch_indices(g)
        assert idx.min() >= g * 64 and idx.max() < (g + 1) * 64
        _assert_same(j.epoch(g), p.epoch(g))
    total = sum(MIX[0])
    j, p = _pair(np.arange(total), streaming=True, horizon=120, batch=16,
                 world=2, rank=1, mixture="mix")
    for g in range(3):
        _assert_same(j.epoch(g), p.epoch(g))


def test_streaming_generation_bump_drops_caches():
    p = HostDataLoader(np.arange(256), streaming=True, horizon=64, window=8,
                       batch=16, index_backend="cpu", device="cpu")
    a = p.epoch_indices(1)
    assert p.epoch_indices(1) is a
    list(p.epoch(1))  # kicks the boundary worker for horizon 2
    p._boundary_thread.join(5.0)
    assert p._boundary_box[0] == 2
    p.epoch_indices(3)  # skips horizon 2: its box must go
    assert p._stream_gen == 3 and p._idx_cache[0][0] == 3
    assert p._boundary_box is None
    with pytest.raises(ValueError):
        HostDataLoader(np.arange(256), streaming=True, window=8, batch=16,
                       index_backend="cpu", device="cpu")
    with pytest.raises(ValueError):
        HostDataLoader(np.arange(256), horizon=64, window=8, batch=16,
                       index_backend="cpu", device="cpu")


def test_boundary_prefetch_adopted_without_foreground_regen():
    j, p = _pair(_data(), window=WINDOW, world=WORLD)
    _assert_same(j.epoch(0), p.epoch(0))
    p._boundary_thread.join(5.0)
    calls = []
    real = p._compute_epoch_indices
    p._compute_epoch_indices = lambda *a: calls.append(a) or real(*a)
    _assert_same(j.epoch(1), p.epoch(1))
    # epoch 1 came from the worker's array (epoch 2's worker is kicked)
    assert [a[0] for a in calls] in ([], [2])
    off = HostDataLoader(_data(), window=WINDOW, batch=BATCH, world=WORLD,
                         index_backend="cpu", device="cpu",
                         boundary_prefetch=False)
    list(off.epoch(0))
    assert off._boundary_thread is None and off._boundary_box is None


def test_early_break_retires_prefetch_thread():
    _j, p = _pair(_data(), window=WINDOW, world=WORLD, depth=2)
    before = set(threading.enumerate())
    it = p.epoch(0)
    next(it)
    it.close()
    for t in set(threading.enumerate()) - before:
        if t.name == "psds-host-prefetch":
            t.join(timeout=5.0)
            assert not t.is_alive(), "prefetch thread leaked"
    assert p._idx_cache is None  # the close path reclaims the cache too


def test_gather_out_of_bounds_raises_index_error():
    for cls, kw in ((JLoader, {}), (HostDataLoader, dict(device="cpu"))):
        class Bad(cls):
            def epoch_indices(self, epoch, layers=None):
                return np.full(self.num_samples, N + 999)

        loader = Bad({"x": np.arange(N)}, window=WINDOW, batch=BATCH,
                     world=WORLD, index_backend="cpu", **kw)
        with pytest.raises(IndexError, match="out of bounds"):
            list(loader.epoch(0))


class _Boom(Exception):
    pass


def test_gather_error_keeps_original_traceback_under_full_queue():
    """The producer hits an error while the queue is FULL (depth 1): the
    consumer still gets the original exception object, its traceback
    reaching into the producer's frames."""
    failed = threading.Event()

    class Failing(HostDataLoader):
        calls = 0

        def _gather(self, sl):
            Failing.calls += 1
            if Failing.calls == 3:
                failed.set()
                perform()
            return super()._gather(sl)

    def perform():
        raise _Boom("gather failed")

    loader = Failing(_data(), window=WINDOW, batch=BATCH, world=WORLD,
                     depth=1, index_backend="cpu", device="cpu")
    it = loader.epoch(0)
    next(it)  # batch 0 taken, batch 1 queued, the third gather fails
    assert failed.wait(5.0)
    with pytest.raises(_Boom) as ei:
        for _ in it:
            pass
    names = []
    tb = ei.value.__traceback__
    while tb is not None:
        names.append(tb.tb_frame.f_code.co_name)
        tb = tb.tb_next
    assert "produce" in names and "perform" in names, names


def test_stalled_gather_raises_stall_error_with_its_stack():
    release = threading.Event()

    class Wedged(HostDataLoader):
        calls = 0

        def _gather(self, sl):
            Wedged.calls += 1
            if Wedged.calls == 2:
                wedged_in_gather()
            return super()._gather(sl)

        def _check_stall(self, thread, progress):
            try:
                super()._check_stall(thread, progress)
            except StallError:
                release.set()  # the stack is taken; let the thread go
                raise

    def wedged_in_gather():
        release.wait(10.0)

    loader = Wedged(_data(), window=WINDOW, batch=BATCH, world=WORLD,
                    index_backend="cpu", device="cpu", stall_timeout=0.3)
    with pytest.raises(StallError) as ei:
        list(loader.epoch(0))
    err = ei.value
    assert err.thread_name == "psds-host-prefetch" and err.thread_alive
    assert "wedged_in_gather" in str(err)
    assert "stack of stalled thread" in str(err)


def test_stall_probe_counts_every_batch():
    _j, p = _pair(_data(), window=WINDOW, world=WORLD)
    probe = StallProbe(p.epoch(0))
    n = sum(1 for _ in probe)
    rep = probe.report()
    assert n == rep["batches"] == p.steps_per_epoch
    assert 0.0 <= probe.stall_fraction <= 1.0
    assert rep["stall_pct"] == round(100.0 * probe.stall_fraction, 3)


def test_index_cache_dropped_on_exhaustion():
    _j, p = _pair(np.arange(N), window=WINDOW, world=WORLD)
    for _ in p.epoch(1):
        pass
    assert p._idx_cache is None
    idx = p.epoch_indices(2)
    assert p.epoch_indices(2) is idx and not idx.flags.writeable
    p.clear_cache()
    assert p._idx_cache is None
    np.testing.assert_array_equal(p.epoch_indices(2), idx)


BAD_ARGS = [
    dict(data={"x": np.arange(10), "y": np.arange(11)}, window=8),
    dict(depth=0),
    dict(index_backend="gpu"),
    dict(rank=5),
    dict(data={}, window=8),
    dict(mixture="mix", window=64),
    dict(data=np.arange(299), mixture="mix"),
    dict(epoch_samples=5),
    dict(mixture=[200, 100]),
    dict(mixture="mix", shard_sizes=[600]),
    dict(shard_sizes=[10, 10]),
    dict(data=np.arange(5), batch=64),
    dict(streaming=True, shard_sizes=[300, 300]),
    dict(bogus=1),
]


@pytest.mark.parametrize("bad", BAD_ARGS, ids=lambda b: ",".join(b))
def test_validation_errors_have_the_same_types(bad):
    bad = dict(bad)
    data = bad.pop("data", np.arange(600))
    if "mixture" not in bad and "shard_sizes" not in bad:
        bad.setdefault("window", 16)
    if bad.get("streaming"):
        bad["horizon"] = 64
    bad.setdefault("batch", 8)
    jkw, pkw = dict(bad), dict(bad)
    if bad.get("mixture") == "mix":
        jkw["mixture"] = JM.MixtureSpec(MIX[0], MIX[1], **MIX[2])
        pkw["mixture"] = MixtureSpec(MIX[0], MIX[1], **MIX[2])
    with pytest.raises(Exception) as ej:
        JLoader(data, index_backend=jkw.pop("index_backend", "cpu"), **jkw)
    with pytest.raises(type(ej.value)):
        HostDataLoader(data, index_backend=pkw.pop("index_backend", "cpu"),
                       device="cpu", **pkw)


def test_start_step_bounds_have_the_same_type():
    j, p = _pair(_data(), window=WINDOW, world=WORLD)
    with pytest.raises(ValueError, match="start_step"):
        j.epoch(0, start_step=999)
    with pytest.raises(ValueError, match="start_step"):
        p.epoch(0, start_step=999)


def test_port_refusals():
    kw = dict(window=WINDOW, batch=BATCH)
    # no card here: 'auto' resolves to the host backend without a probe
    for backend in ("auto", "native"):
        loader = HostDataLoader(_data(), index_backend=backend,
                                device="cpu", **kw)
        assert loader.index_backend == "native"
        assert loader._auto_cost is None
    # the served modes are accepted, with the JAX loader's defaults
    loader = HostDataLoader(_data(), index_backend="cpu", device="cpu",
                            index_client=object(), capability_mode=True,
                            **kw)
    assert loader.degraded_fallback is True
    assert loader.reattach_interval == 5.0 and loader.degraded is False
    with pytest.raises(ValueError, match="elastic layers"):
        loader._compute_epoch_indices(0, [(2, 10)])
    # the card is the default on both sides, and there is none here
    with pytest.raises(CudaUnavailableError):
        HostDataLoader(_data(), device="cpu", **kw)
    with pytest.raises(CudaUnavailableError):
        HostDataLoader(_data(), index_backend="cpu", **kw)
    with pytest.raises(CudaUnavailableError):
        HostDataLoader(_data(), index_backend="cpu", device="cuda:0", **kw)
    with pytest.raises(TypeError, match="use_pallas"):
        HostDataLoader(_data(), index_backend="cpu", device="cpu",
                       use_pallas=True, **kw)
    with pytest.raises(TypeError, match="torch counterpart"):
        HostDataLoader(np.array(["a"] * N), index_backend="cpu",
                       device="cpu", **kw)
