"""The port's torch surface against the JAX package's: the sampler's
streams, the sampler checkpoint carried across the two packages in both
directions (the only state this system has), elastic resharding across
packages, and the device iterator — all on the CPU backend, tolerance 0.
"""

import numpy as np
import pytest
import torch
from torch.utils.data import DataLoader, TensorDataset

from partiallyshuffledistributedsampler_tpu.ops import cpu as jcpu
from partiallyshuffledistributedsampler_tpu.sampler.torch_shim import (
    PartiallyShuffleDistributedSampler as JaxSampler,
)
from partiallyshuffledistributedsampler_tpu_torch import (
    CudaUnavailableError,
    DeviceEpochIterator,
    PartiallyShuffleDistributedSampler as TorchSampler,
    RegenTimer,
    StatefulDataLoader,
    batch_index_window,
)

N, WINDOW = 5003, 128


def _pair(rank, world, **kw):
    kw = dict(window=WINDOW, backend="cpu", **kw)
    return JaxSampler(N, world, rank, **kw), TorchSampler(N, world, rank, **kw)


@pytest.mark.parametrize("rank,world,epoch,kw", [
    (0, 1, 0, {}),
    (3, 8, 1, {}),
    (7, 8, 5, dict(partition="blocked")),
    (1, 3, 2, dict(drop_last=True)),
    (2, 4, 9, dict(order_windows=False, seed=2**40 + 3)),
    (0, 2, 4, dict(shuffle=False)),
])
def test_sampler_stream_matches_jax_package(rank, world, epoch, kw):
    js, ts = _pair(rank, world, **kw)
    for s in (js, ts):
        s.set_epoch(epoch)
    want = list(js)
    assert list(ts) == want
    assert len(ts) == len(js) == len(want)
    np.testing.assert_array_equal(ts.epoch_indices(epoch + 1),
                                  js.epoch_indices(epoch + 1))


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
@pytest.mark.parametrize("partition", ["strided", "blocked"])
def test_mid_epoch_checkpoint_carries_across_packages(direction, partition):
    rng = np.random.default_rng(17)
    k = int(rng.integers(1, N // 4))
    js, ts = _pair(1, 4, seed=9, partition=partition)
    src, dst_cls = (js, TorchSampler) if direction == "jax_to_torch" \
        else (ts, JaxSampler)
    src.set_epoch(6)
    full = list(src)
    it = iter(src)
    head = [next(it) for _ in range(k)]
    state = src.state_dict()
    assert state["offset"] == k and state["epoch"] == 6
    dst = dst_cls(N, 4, 1, window=WINDOW, seed=0, partition=partition,
                  backend="cpu")
    dst.load_state_dict(state)
    assert len(dst) == len(full) - k
    assert head + list(dst) == full


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_reshard_from_state_dict_across_packages(direction):
    js, ts = _pair(2, 4, seed=5)
    src, cls, ref_cls = (js, TorchSampler, JaxSampler) \
        if direction == "jax_to_torch" else (ts, JaxSampler, TorchSampler)
    src.set_epoch(3)
    it = iter(src)
    for _ in range(301):
        next(it)
    state = src.state_dict()
    for new_rank in range(3):
        got = cls.reshard_from_state_dict(state, 3, new_rank, backend="cpu")
        want = ref_cls.reshard_from_state_dict(state, 3, new_rank,
                                               backend="cpu")
        assert list(got) == list(want)
        assert got.state_dict() == want.state_dict()
        # the next epoch is an ordinary epoch at the new world size
        got.set_epoch(4)
        want.set_epoch(4)
        assert list(got) == list(want)


def test_cascaded_reshard_state_carries_across_packages():
    js = JaxSampler(N, 4, 0, window=WINDOW, backend="cpu", seed=1)
    js.set_epoch(2)
    it = iter(js)
    for _ in range(100):
        next(it)
    mid = TorchSampler.reshard_from_state_dict(js.state_dict(), 3, 1,
                                               backend="cpu")
    it = iter(mid)
    for _ in range(50):
        next(it)
    st = mid.state_dict()
    assert st["elastic"]["layers"] == [[4, 100]]
    got = TorchSampler.reshard_from_state_dict(st, 2, 0, backend="cpu")
    want = JaxSampler.reshard_from_state_dict(st, 2, 0, backend="cpu")
    assert list(got) == list(want)
    np.testing.assert_array_equal(
        got.epoch_indices(),
        jcpu.elastic_indices_np(N, WINDOW, 1, 2, 0, 2, [(4, 100), (3, 50)]))


def test_load_state_dict_validates_before_assigning():
    _js, ts = _pair(0, 2)
    ts.set_epoch(1)
    before = ts.state_dict()
    bad = dict(before, window=WINDOW * 2)
    with pytest.raises(ValueError, match="window"):
        ts.load_state_dict(bad)
    with pytest.raises(ValueError, match="offset"):
        ts.load_state_dict(dict(before, offset=10**9))
    with pytest.raises(ValueError, match="spec version"):
        ts.load_state_dict(dict(before, spec_version=99))
    with pytest.raises(ValueError, match="kind"):
        ts.load_state_dict(dict(before, kind="mixture"))
    assert ts.state_dict() == before


def test_set_epoch_prefetch_and_regen_timer():
    _js, ts = _pair(1, 2)
    ts.set_epoch(4)
    assert ts._pending_epoch == 4
    ts.set_epoch(4)  # the prefetch in flight is kept
    got = ts.epoch_indices()
    assert ts._pending is None
    np.testing.assert_array_equal(
        got, jcpu.epoch_indices_np(N, WINDOW, 0, 4, 1, 2))
    assert ts.regen_timer.count == 1 and ts.regen_timer.last_ms >= 0
    t = RegenTimer(max_samples=2)
    for _ in range(3):
        with t.measure():
            pass
    assert t.count == 3 and len(t.samples_ms) == 2


def test_dataloader_union_is_exactly_once():
    ds = TensorDataset(torch.arange(N))
    seen = []
    for rank in range(4):
        s = TorchSampler(ds, 4, rank, window=WINDOW, backend="cpu")
        s.set_epoch(2)
        seen += [b for (b,) in DataLoader(ds, batch_size=64, sampler=s)]
    counts = np.bincount(torch.cat(seen).numpy(), minlength=N)
    assert counts.min() == 1 and counts.sum() == 4 * -(-N // 4)


def test_stateful_loader_resumes_exactly():
    ds = TensorDataset(torch.arange(N))
    s = TorchSampler(ds, 2, 1, window=WINDOW, backend="cpu")
    loader = StatefulDataLoader(ds, batch_size=50, sampler=s)
    s.set_epoch(3)
    got = []
    for step, (b,) in enumerate(loader):
        got.append(b)
        if step == 9:
            ckpt = loader.state_dict()
            break
    s2 = TorchSampler(ds, 2, 1, window=WINDOW, backend="cpu")
    loader2 = StatefulDataLoader(ds, batch_size=50, sampler=s2)
    loader2.load_state_dict(ckpt)
    got += [b for (b,) in loader2]
    np.testing.assert_array_equal(
        torch.cat(got).numpy(), jcpu.epoch_indices_np(N, WINDOW, 0, 3, 1, 2))


@pytest.mark.parametrize("drop_last_batch", [True, False])
def test_device_iterator_batches_are_slices_of_the_epoch(drop_last_batch):
    it = DeviceEpochIterator(N, WINDOW, 64, seed=7, rank=2, world=3,
                             drop_last_batch=drop_last_batch, device="cpu")
    for epoch in (0, 1):
        want = jcpu.epoch_indices_np(N, WINDOW, 7, epoch, 2, 3)
        batches = list(it.epoch(epoch))
        assert len(batches) == it.steps_per_epoch
        assert epoch + 1 in it._cache  # the next epoch was prefetched
        for s, b in enumerate(batches):
            assert b.dtype == torch.int32
            np.testing.assert_array_equal(b.numpy(),
                                          want[s * 64:(s + 1) * 64])
    assert sum(len(b) for b in batches) == (
        len(want) if not drop_last_batch else len(want) // 64 * 64)


def test_batch_index_window_one_and_two_dims():
    idx = torch.arange(40, dtype=torch.int32)
    assert batch_index_window(idx, 2, 8).tolist() == list(range(16, 24))
    two = idx.reshape(2, 20)
    assert batch_index_window(two, 1, 5).tolist() == [list(range(5, 10)),
                                                      list(range(25, 30))]


def test_cuda_backend_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    with pytest.raises(CudaUnavailableError):
        TorchSampler(N, 2, 0)  # backend='cuda' is the default
    with pytest.raises(CudaUnavailableError):
        DeviceEpochIterator(N, WINDOW, 64)
    with pytest.raises(ValueError, match="JAX package"):
        TorchSampler(N, 2, 0, backend="xla")


def test_device_iterator_rejects_bad_shapes():
    with pytest.raises(ValueError, match="rank"):
        DeviceEpochIterator(N, WINDOW, 64, rank=3, world=3, device="cpu")
    with pytest.raises(ValueError, match="batch"):
        DeviceEpochIterator(100, 16, 64, world=2, device="cpu")


@pytest.mark.parametrize("layers,drop_last_batch", [
    ([(4, 300)], True),
    ([(4, 300)], False),
    ([(5, 100), (3, 40)], False),
    ([(3, 1668)], True),  # fully consumed: an empty remainder
])
def test_device_iterator_elastic_epoch_matches_jax_iterator(
        layers, drop_last_batch):
    from partiallyshuffledistributedsampler_tpu.sampler.jax_iterator import (
        DeviceEpochIterator as JaxIterator,
    )

    it = DeviceEpochIterator(N, WINDOW, 64, seed=7, rank=1, world=2,
                             drop_last_batch=drop_last_batch, device="cpu")
    jit = JaxIterator(N, WINDOW, 64, seed=7, rank=1, world=2,
                      drop_last_batch=drop_last_batch)
    want = np.asarray(jit.elastic_epoch_array(4, layers))
    got = it.elastic_epoch_array(4, layers)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        want, jcpu.elastic_indices_np(N, WINDOW, 7, 4, 1, 2, layers))
    batches = list(it.elastic_epoch(4, layers))
    jbatches = [np.asarray(b) for b in jit.elastic_epoch(4, layers)]
    assert [len(b) for b in batches] == [len(b) for b in jbatches]
    for b, jb in zip(batches, jbatches):
        np.testing.assert_array_equal(b.numpy(), jb)
