"""The shard expansion launches with remembered size tables and confirms
them after its launches (``ops/shard.py``: ``remembered_tables``,
``confirm_tables``, ``table_checks``), on the CPU against the JAX
package's ``expand_shard_indices_np``: a hit returns the first output, a
miss (sizes changed in place) launches again with the confirmed tables,
and every answer is exact.  The tables are remembered by the sizes
object, so another array, even of equal contents or of the same length,
is looked up first and never costs a wasted launch.  Both routes: the
entry ``expand_shard_indices_cuda(device="cpu")`` and a CPU-backend
``PartialShuffleShardSampler.device_epoch_indices``.  The card's version
is ``tests/test_torch_port_gpu_shard_speculative.py``.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from partiallyshuffledistributedsampler_tpu.ops import cpu as jcpu
from partiallyshuffledistributedsampler_tpu.sampler import shard_mode as J
from partiallyshuffledistributedsampler_tpu_torch import (
    PartialShuffleShardSampler,
    expand_shard_indices_cuda,
)
from partiallyshuffledistributedsampler_tpu_torch.ops import core
from partiallyshuffledistributedsampler_tpu_torch.ops import shard as S

SEED, EPOCH, RANK, WORLD, WINDOW, WSS = 5, 2, 1, 4, 64, 6
N = 48
#: the rank's shard stream, as the sampler draws it
IDS = jcpu.epoch_indices_np(N, WINDOW, SEED, EPOCH, RANK, WORLD)
#: a shard outside the rank's stream: it may grow past 2^31 samples
SPARE = min(set(range(N)) - set(IDS.tolist()))


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """Nothing remembered, no checks counted."""
    monkeypatch.setattr(S, "_confirmed", {})
    S.reset_table_checks()


def _entry(sizes):
    return expand_shard_indices_cuda(IDS, sizes, seed=SEED, epoch=EPOCH,
                                     within_shard_shuffle=WSS, device="cpu")


_SAMPLERS: dict = {}


def _sampler(sizes):
    n = len(sizes)  # a sampler over as many shards as there are sizes
    if n not in _SAMPLERS:
        _SAMPLERS[n] = PartialShuffleShardSampler(
            n, num_replicas=WORLD, rank=RANK, seed=SEED, window=WINDOW,
            backend="cpu")
    return _SAMPLERS[n].device_epoch_indices(sizes, epoch=EPOCH,
                                             within_shard_shuffle=WSS)


ROUTES = {"entry": _entry, "sampler": _sampler}


def _want(route, sizes):
    ids = IDS if route == "entry" else jcpu.epoch_indices_np(
        len(sizes), WINDOW, SEED, EPOCH, RANK, WORLD)
    return np.asarray(J.expand_shard_indices_np(
        ids, sizes, seed=SEED, epoch=EPOCH, within_shard_shuffle=WSS))


def _sizes():
    return np.random.default_rng(11).integers(1, 30, N).astype(np.int64)


# each case yields the sizes of one regen after another (a generator, so
# an in-place change falls between two regens), then the expected checks
def _same(sizes):
    yield sizes
    yield sizes


def _copy(sizes):
    # another object: looked up first, then remembered in its own right
    yield sizes
    copy = sizes.copy()
    yield copy
    yield copy


def _alternate(sizes):
    # two arrays of the same length in turns, as two specs served from
    # one process: each launches with its own tables
    other = sizes[::-1].copy()
    for _ in range(3):
        yield sizes
        yield other


def _in_place(sizes):
    # the case of test_shard_tables_follow_the_sizes_contents: the same
    # length and sum, other contents
    yield sizes
    sizes[3], sizes[4] = sizes[3] - 1, sizes[4] + 1
    yield sizes


def _longer(sizes):
    yield sizes
    yield np.append(sizes, 9)


def _uniform_to_wide(sizes):
    # uniform int32 tables, then mixed sizes whose space passes 2^31: the
    # guess's m_uniform and out_dtype are both wrong
    sizes[:] = 7
    yield sizes
    sizes[SPARE] = core.INT32_MAX
    yield sizes


CASES = [
    ("same", _same, {"hits": 1, "misses": 0}),
    ("copy", _copy, {"hits": 1, "misses": 0}),
    ("alternate", _alternate, {"hits": 4, "misses": 0}),
    ("in-place", _in_place, {"hits": 0, "misses": 1}),
    ("longer", _longer, {"hits": 0, "misses": 0}),
    ("uniform-to-wide", _uniform_to_wide, {"hits": 0, "misses": 1}),
]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case,regens,checks", CASES,
                         ids=[c[0] for c in CASES])
def test_each_regen_is_confirmed_and_exact(route, case, regens, checks):
    for sizes in regens(_sizes()):
        got = ROUTES[route](sizes)
        want = _want(route, sizes)
        assert got.dtype == core.out_dtype(int(sizes.sum()))
        assert got.numel() == want.size
        np.testing.assert_array_equal(got.numpy(), want)
    assert S.table_checks == checks
    if case == "uniform-to-wide":
        assert got.dtype == torch.int64
        assert S.remembered_tables(sizes, "cpu").m_uniform is None


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("lengths", ["one", "many"])
def test_more_tables_than_the_caches_hold_stay_exact(route, lengths):
    base, extra = _sizes(), S._TABLES_CAP + 3
    if lengths == "one":  # other contents, each an array of its own
        tables = [base + k for k in range(extra)]
    else:  # a length each: what is remembered is evicted before its turn
        tables = [np.append(base, np.arange(1, k + 1)) for k in range(extra)]
    for _ in range(2):
        for sizes in tables:
            np.testing.assert_array_equal(ROUTES[route](sizes).numpy(),
                                          _want(route, sizes))
    # what is remembered is evicted before its turn comes again
    assert S.table_checks == {"hits": 0, "misses": 0}


def test_a_guess_that_raises_is_dropped_on_a_miss():
    # four sizes remembered; then, in place, four rows of three: the
    # guess's tables hold four shards, so shard 9 is out of range for them
    # alone
    sizes = [4, 5, 6, 7]
    _ = expand_shard_indices_cuda([1, 3], sizes, device="cpu")
    sizes[:] = [[2, 3, 4]] * 4
    got = expand_shard_indices_cuda([9, 0], sizes, device="cpu")
    np.testing.assert_array_equal(
        got.numpy(), J.expand_shard_indices_np([9, 0], np.ravel(sizes)))
    assert S.table_checks == {"hits": 0, "misses": 1}


def test_a_guess_that_raises_on_a_hit_raises():
    sizes = _sizes()
    _ = expand_shard_indices_cuda([1], sizes, device="cpu")
    with pytest.raises(ValueError, match="shard ids must be in"):
        expand_shard_indices_cuda([N], sizes, device="cpu")
    assert S.table_checks == {"hits": 1, "misses": 0}


def test_one_pass_ids_are_read_again_by_a_relaunch():
    sizes = _sizes()
    _ = _entry(sizes)
    sizes[0] += 1  # a miss: the ids are launched twice
    got = expand_shard_indices_cuda(iter(IDS.tolist()), sizes, seed=SEED,
                                    epoch=EPOCH, within_shard_shuffle=WSS,
                                    device="cpu")
    np.testing.assert_array_equal(got.numpy(), _want("entry", sizes))
    assert S.table_checks == {"hits": 0, "misses": 1}


def test_threads_lose_no_check():
    sizes = _sizes()
    want = _want("entry", sizes)
    _ = _entry(sizes)
    threads, regens, bad = 9, 10, []  # more threads than cores

    def work():
        for _ in range(regens):
            if not np.array_equal(_entry(sizes).numpy(), want):
                bad.append(1)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    assert not bad
    assert S.table_checks == {"hits": threads * regens, "misses": 0}
