"""The port's shard-index mode (SPEC.md §7) on the CPU against the JAX
package: the per-shard seed, the within-shard order, the shuffle buffer,
the expansion through every evaluator of the port (the host reference
``expand_shard_indices_cpu``, the kernels' plain versions, the entry
``expand_shard_indices_cuda(device="cpu")``) against
``expand_shard_indices_np`` and ``expand_shard_indices_jax``, the int64
shard space, and the shard sampler with checkpoints and elastic reshards.
Tolerance 0 everywhere: the law is integer-exact.  The kernels themselves
are tested on the card by ``tests/test_torch_port_gpu.py``.
"""

import json
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from partiallyshuffledistributedsampler_tpu.ops import core as jcore
from partiallyshuffledistributedsampler_tpu.ops import cpu as jcpu
from partiallyshuffledistributedsampler_tpu.sampler import shard_mode as J
from partiallyshuffledistributedsampler_tpu_torch import (
    CudaUnavailableError,
    PartialShuffleShardSampler,
    expand_shard_indices,
    expand_shard_indices_cpu,
    expand_shard_indices_cuda,
    expand_shard_indices_generic,
    shard_sample_order,
    shard_seed,
    shuffle_buffer,
)
from partiallyshuffledistributedsampler_tpu_torch.ops import (
    cuda_kernel as ck,
    shard as S,
)
from partiallyshuffledistributedsampler_tpu_torch.sampler import shard_mode as P

#: the goldens' shard table of tests/test_shard_mode.py (shard 1 empty)
_SIZES = [5, 0, 7, 3, 4]
MODES = [True, 1, False, 0, 9, np.int64(9), 5000]
_RNG = np.random.default_rng(3)
#: (id, sizes, shard-id stream): one size class; a few classes with
#: zero-size and size-1 shards (JAX: one program per class); more than 16
#: distinct sizes (JAX: the power-of-two buckets)
SIZE_CASES = [
    ("uniform", [40] * 60, _RNG.permutation(60)[:45]),
    ("classes", _RNG.choice([0, 1, 7, 13, 40], 60).tolist(),
     _RNG.permutation(60)[:45]),
    ("buckets", np.concatenate([_RNG.integers(0, 40, 60), [0, 0, 1, 1, 2]]),
     _RNG.permutation(65)[:50]),
]


def _ids(case):
    return [c[0] for c in case]


# ------------------------------------------------------------ goldens
def test_goldens_frozen():
    assert shard_seed(3, 2) == 11400714819323198484 == J.shard_seed(3, 2)
    assert shard_seed(0, 0) == 0x9E3779B97F4A7C15
    assert shard_sample_order(2, 7, seed=3, epoch=1).tolist() == [
        5, 3, 6, 1, 2, 4, 0]
    gold = [10, 8, 11, 6, 7, 9, 5, 1, 2, 0, 3, 4, 13, 12, 14]
    bounded = [5, 6, 8, 7, 9, 10, 11, 0, 1, 3, 2, 4, 12, 13, 14]
    for fn in (expand_shard_indices_cpu, expand_shard_indices_generic):
        assert fn([2, 0, 3], _SIZES, seed=3, epoch=1).tolist() == gold
        assert fn([2, 0, 3], _SIZES, seed=3, epoch=1,
                  within_shard_shuffle=2).tolist() == bounded
    got = expand_shard_indices_cuda([2, 0, 3], _SIZES, seed=3, epoch=1,
                                    device="cpu")
    assert got.dtype == torch.int32 and got.tolist() == gold
    assert list(shuffle_buffer(range(12), 4, seed=5, epoch=0)) == [
        3, 4, 1, 5, 0, 6, 8, 2, 11, 9, 10, 7]


# --------------------------------------------------------- host laws
@pytest.mark.parametrize("sid,m", [(0, 1), (2, 7), (9, 64), (123, 1000),
                                   (2**32 - 1, 50)])
def test_shard_sample_order_matches_jax(sid, m):
    for wss in MODES + [16, 999]:
        for seed in (0, (1 << 77) + 12345, -3):
            np.testing.assert_array_equal(
                shard_sample_order(sid, m, seed=seed, epoch=4,
                                   within_shard_shuffle=wss).numpy(),
                J.shard_sample_order(sid, m, seed=seed, epoch=4,
                                     within_shard_shuffle=wss))


def test_within_shard_window_rules():
    for m in (0, 1, 5, 100):
        for wss in MODES + [64]:
            assert (P._within_shard_window(m, wss)
                    == J._within_shard_window(m, wss))
    assert P._within_shard_window(100, True) == 100
    assert P._within_shard_window(100, np.int64(9)) == 9  # never a full shuffle
    assert P._within_shard_window(100, False) == 0
    assert P._within_shard_window(5, 64) == 5
    with pytest.raises(ValueError, match="within_shard_shuffle"):
        P._within_shard_window(5, -1)


@pytest.mark.parametrize("seed", [0, 7, (1 << 64) - 1, (1 << 77) + 12345,
                                  -1])
def test_shard_epoch_keys_match_jax(seed):
    sids = np.array([0, 1, 2**31, 2**32 - 1, 0x61C88646, 0x61C88647, 5],
                    dtype=np.int64)
    lo, hi = P._shard_epoch_keys(torch.from_numpy(sids), seed)
    jlo, jhi = J._shard_epoch_keys(np, sids, seed)
    np.testing.assert_array_equal(lo.numpy(), jlo.astype(np.int64))
    np.testing.assert_array_equal(hi.numpy(), jhi.astype(np.int64))
    for s, l, h in zip(sids, lo.tolist(), hi.tolist()):
        assert (l, h) == jcore.fold_seed(J.shard_seed(seed, int(s)))


def test_rowwise_swap_matches_jax():
    rng = np.random.default_rng(5)
    m = rng.integers(0, 3000, (40, 1)).astype(np.uint32)
    x = (rng.integers(0, 1 << 31, (40, 64)) % np.maximum(m, 1)).astype(
        np.uint32)
    key = rng.integers(0, 1 << 32, (40, 64)).astype(np.uint32)
    pair = rng.integers(0, 1 << 32, (40, 1)).astype(np.uint32)
    want = J._rowwise_swap(np, x, m, key, pair, 24)
    t = [torch.from_numpy(a.astype(np.int64)) for a in (x, m, key, pair)]
    np.testing.assert_array_equal(P._rowwise_swap(*t, 24).numpy(),
                                  want.astype(np.int64))


def test_validate_and_size_classes_match_jax():
    m_of = _RNG.integers(0, 9, 200)
    got = [(m, list(mem)) for m, mem in P._size_class_members(m_of)]
    assert got == [(m, list(mem)) for m, mem in J._size_class_members(m_of)]
    for bad in (np.array([0, 5]), np.array([-1, 2])):
        with pytest.raises(ValueError, match="shard ids"):
            J._validate_sids(bad, 5)
        with pytest.raises(ValueError, match="shard ids"):
            P._validate_sids(bad, 5)
    P._validate_sids(np.array([0, 4]), 5)


def test_shuffle_buffer_matches_jax():
    for n, b, seed, epoch in ((500, 32, 1, 2), (100, 8, 4, 0), (20, 1, 0, 0),
                              (57, 100, (1 << 40) + 3, 9)):
        assert (list(shuffle_buffer(range(n), b, seed=seed, epoch=epoch))
                == list(J.shuffle_buffer(range(n), b, seed=seed,
                                         epoch=epoch)))
    with pytest.raises(ValueError, match="buffer_size"):
        list(shuffle_buffer(range(5), 0))


# ------------------------------------------------------- the expansion
@pytest.mark.parametrize("cid,sizes,ids", SIZE_CASES, ids=_ids(SIZE_CASES))
def test_expansion_matches_np_and_jax(cid, sizes, ids):
    ids = list(ids)
    if cid == "buckets":
        assert len({int(sizes[i]) for i in ids}) > J._MAX_CLASS_PROGRAMS
    for wss in MODES:
        for epoch in (0, 5):
            kw = dict(seed=4, epoch=epoch, within_shard_shuffle=wss)
            want = J.expand_shard_indices_np(ids, sizes, **kw)
            dev = np.asarray(J.expand_shard_indices_jax(ids, sizes, **kw))
            np.testing.assert_array_equal(dev, want)
            host = expand_shard_indices_cpu(ids, sizes, **kw)
            assert host.dtype == torch.int64
            np.testing.assert_array_equal(host.numpy(), want)
            for got in (expand_shard_indices_generic(ids, sizes, **kw),
                        expand_shard_indices_generic(torch.tensor(ids),
                                                     sizes, **kw),
                        expand_shard_indices_cuda(ids, sizes, device="cpu",
                                                  **kw)):
                assert got.dtype == torch.int32
                np.testing.assert_array_equal(got.numpy(), dev)


def test_generator_matches_np():
    sizes = _RNG.integers(0, 90, 200).tolist()
    ids = _RNG.permutation(200)[:120].tolist()
    for wss in (True, False, 7):
        kw = dict(seed=11, epoch=3, within_shard_shuffle=wss)
        assert (list(expand_shard_indices(ids, sizes, **kw))
                == list(J.expand_shard_indices(ids, sizes, **kw))
                == J.expand_shard_indices_np(ids, sizes, **kw).tolist())


def test_empty_and_zero_size_selections():
    for ids in ([], [1, 1]):
        for fn in (expand_shard_indices_cpu, expand_shard_indices_generic):
            assert fn(ids, _SIZES).tolist() == []
        assert expand_shard_indices_cuda(ids, _SIZES,
                                         device="cpu").tolist() == []
    assert expand_shard_indices_cuda([1], [0] * 4, device="cpu").tolist() == []


def test_plain_kernel_versions_match_jax_columns():
    """``shard_row_keys_ref``'s records hold the JAX package's per-row key
    columns and pairing constants; ``shard_expand_ref`` over them is the
    expansion."""
    sizes = _RNG.integers(0, 300, 80)
    sids = _RNG.permutation(80)[:60]
    seed, epoch, rounds = (1 << 40) + 0xFFFFFFF7, 0xFFFFFFF0, 24
    tabs = S.shard_tables(sizes, "cpu")
    sid_t = torch.from_numpy(sids.astype(np.int32))
    for wss in (True, 0, 1, 9, 64, 5000):
        full, w = S.shuffle_mode(wss)
        rows, m_of = ck.shard_row_keys_ref(sid_t, tabs.dev_sizes, seed,
                                           epoch, full=full, w=w,
                                           rounds=rounds)
        rows = rows.view(-1, S.row_words(rounds)).numpy().view(np.uint32)
        lo, hi = J._shard_epoch_keys(np, sids, seed)
        ek = jcore.derive_epoch_key(np, (lo, hi), epoch)
        m = sizes[sids]
        W = m if full else np.minimum(w, m)
        body = np.where(W > 1, m // np.maximum(W, 1) * W, m)
        pair, tk = jcore.inner_pair_key(np, ek), jcore.tail_key(np, ek)
        np.testing.assert_array_equal(m_of.numpy(), m)
        np.testing.assert_array_equal(rows[:, :4], np.stack(
            [ek, pair, tk, body.astype(np.uint32)], axis=1))
        for r in range(rounds):
            g = np.uint32((r * jcore._GOLDEN) & jcore._M32)
            for col, key, dom in ((4 + r, pair, W),
                                  (4 + rounds + r, tk, m - body)):
                want = np.where(dom > 1, jcore.mix32(np, key ^ g)
                                % np.maximum(dom, 1).astype(np.uint32), 0)
                np.testing.assert_array_equal(rows[:, col], want)
        ends = torch.cumsum(m_of, 0)
        got = ck.shard_expand_ref(
            torch.from_numpy(rows.view(np.int32).reshape(-1)), sid_t,
            tabs.dev_offsets, ends, m_uniform=None, lanes=int(ends[-1]),
            full=full, w=w, rounds=rounds, out_dtype=torch.int64)
        np.testing.assert_array_equal(
            got.numpy(), J.expand_shard_indices_np(
                sids, sizes, seed=seed, epoch=epoch,
                within_shard_shuffle=wss))


def test_device_triple_matches_scalars_on_cpu():
    bits = np.array([0xFFFFFFF7, 0x100, 0xFFFFFFF0], dtype=np.uint32)
    triple = torch.from_numpy(bits.view(np.int32))
    sizes = _RNG.integers(0, 50, 40).tolist()
    ids = _RNG.permutation(40)
    for wss in (True, 6):
        got = expand_shard_indices_cuda(ids, sizes, seed=None, epoch=None,
                                        within_shard_shuffle=wss,
                                        device="cpu", triple=triple)
        want = J.expand_shard_indices_np(ids, sizes, seed=(1 << 40) + (
            0xFFFFFFF7), epoch=0xFFFFFFF0, within_shard_shuffle=wss)
        np.testing.assert_array_equal(got.numpy(), want)


def test_shard_tables_follow_the_sizes_contents():
    sizes = np.full(50, 7, dtype=np.int64)
    first = S.shard_tables(sizes, "cpu")
    assert S.shard_tables(sizes.copy(), "cpu") is first
    sizes[3], sizes[4] = 6, 8  # same length and sum, other contents
    again = S.shard_tables(sizes, "cpu")
    assert again is not first and again.m_uniform is None
    np.testing.assert_array_equal(again.dev_sizes.numpy(), sizes)
    np.testing.assert_array_equal(
        expand_shard_indices_cuda([3, 4], sizes, device="cpu").numpy(),
        J.expand_shard_indices_np([3, 4], sizes))


# ----------------------------------------------- the int64 shard space
_BIG_SIZES = [10**9, 1_500_000_000, 7, 5, 9]
_BIG_IDS = [3, 2, 4]
_BIG_MODES = [True, 3, False]

_JAX_X64 = textwrap.dedent("""
    import json, os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    import partiallyshuffledistributedsampler_tpu as psds
    psds.enable_big_index_space()
    from partiallyshuffledistributedsampler_tpu.sampler import shard_mode
    sizes, ids, modes = json.loads(sys.argv[1])
    rows = {}
    for i, wss in enumerate(modes):
        a = shard_mode.expand_shard_indices_jax(
            ids, sizes, seed=9, epoch=2, within_shard_shuffle=wss)
        rows[str(i)] = np.asarray(a)
        rows[f"dtype{i}"] = np.asarray(str(a.dtype))
    np.savez(sys.argv[2], **rows)
""")


def test_int64_shard_space_matches_jax_x64(tmp_path):
    """The whole shard space (2.5e9) passes 2^31 while the selection stays
    tiny: the index type is int64 on every route, as JAX decides it by
    ``total_space``."""
    out = tmp_path / "out.npz"
    res = subprocess.run(
        [sys.executable, "-c", _JAX_X64,
         json.dumps([_BIG_SIZES, _BIG_IDS, _BIG_MODES]), str(out)],
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    jax_rows = dict(np.load(out))
    for i, wss in enumerate(_BIG_MODES):
        kw = dict(seed=9, epoch=2, within_shard_shuffle=wss)
        assert str(jax_rows[f"dtype{i}"]) == "int64"
        want = J.expand_shard_indices_np(_BIG_IDS, _BIG_SIZES, **kw)
        np.testing.assert_array_equal(jax_rows[str(i)], want)
        assert want.min() > 2**31
        for got in (expand_shard_indices_cuda(_BIG_IDS, _BIG_SIZES,
                                              device="cpu", **kw),
                    expand_shard_indices_generic(_BIG_IDS, _BIG_SIZES, **kw)):
            assert got.dtype == torch.int64
            np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            expand_shard_indices_cpu(_BIG_IDS, _BIG_SIZES, **kw).numpy(),
            want)


# ------------------------------------------------------ the sampler
def test_shard_sampler_stream_matches_jax():
    for world, rank in ((4, 2), (3, 0)):
        s = PartialShuffleShardSampler(37, num_replicas=world, rank=rank,
                                       seed=5, backend="cpu")
        j = J.PartialShuffleShardSampler(37, num_replicas=world, rank=rank,
                                         seed=5, backend="cpu")
        assert s.window == j.window == 64
        for e in (0, 2):
            s.set_epoch(e)
            j.set_epoch(e)
            assert list(s) == list(j)
        assert s.state_dict() == j.state_dict()


def test_device_epoch_indices_leaves_the_prefetch():
    s = PartialShuffleShardSampler(64, num_replicas=4, rank=2, seed=6,
                                   backend="cpu")
    j = J.PartialShuffleShardSampler(64, num_replicas=4, rank=2, seed=6,
                                     backend="cpu")
    s.set_epoch(3)
    j.set_epoch(3)
    pending = s._pending
    for sizes, wss in (([25] * 64, 5), ([9 * (i % 3) for i in range(64)],
                                        True)):
        got = s.device_epoch_indices(sizes, within_shard_shuffle=wss)
        assert s.state_dict()["offset"] == 0
        assert s._pending is pending and s._pending_epoch == 3
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(j.device_epoch_indices(
                sizes, within_shard_shuffle=wss)))
    other = s.device_epoch_indices([25] * 64, epoch=4)
    np.testing.assert_array_equal(other.numpy(), np.asarray(
        j.device_epoch_indices([25] * 64, epoch=4)))
    assert list(s) == list(j)  # the training pass takes the prefetch
    assert s._pending is None


def test_elastic_reshard_exactly_once_and_checkpoints_across_packages():
    from conftest import assert_exactly_once

    old_world, new_world, num_shards, consumed = 3, 5, 97, 7
    consumed_ids = []
    for r in range(old_world):
        s = PartialShuffleShardSampler(num_shards, num_replicas=old_world,
                                       rank=r, seed=8, backend="cpu")
        s.set_epoch(4)
        it = iter(s)
        consumed_ids += [next(it) for _ in range(consumed)]
        it.close()
        if r == 0:
            state = s.state_dict()
    remainder_ids = []
    sizes = [4] * num_shards
    for r in range(new_world):
        es = PartialShuffleShardSampler.reshard_from_state_dict(
            state, num_replicas=new_world, rank=r, backend="cpu")
        js = J.PartialShuffleShardSampler.reshard_from_state_dict(
            state, num_replicas=new_world, rank=r, backend="cpu")
        mine = list(es)
        assert mine == list(js)
        remainder_ids += mine
        assert es.state_dict() == js.state_dict()
        np.testing.assert_array_equal(
            es.device_epoch_indices(sizes).numpy(),
            np.asarray(js.device_epoch_indices(sizes)))
    stream = jcpu.full_epoch_stream_np(num_shards, 64, 8, 4,
                                       world=old_world)
    assert_exactly_once(consumed_ids, remainder_ids, stream, old_world,
                        consumed, "strided", new_world)
    # a JAX checkpoint resumes the port's sampler, and the other way round
    j = J.PartialShuffleShardSampler(num_shards, num_replicas=3, rank=1,
                                     seed=8, backend="cpu")
    j.set_epoch(4)
    p = PartialShuffleShardSampler(num_shards, num_replicas=3, rank=1,
                                   seed=8, backend="cpu")
    p.load_state_dict(j.state_dict(consumed=5))
    j2 = J.PartialShuffleShardSampler(num_shards, num_replicas=3, rank=1,
                                      seed=8, backend="cpu")
    j2.load_state_dict(p.state_dict())
    assert list(p) == list(j2) == list(j)[5:]


# ------------------------------------------------------------ refusals
def test_refusals_before_allocation():
    with pytest.raises(ValueError, match="within_shard_shuffle"):
        expand_shard_indices_cuda([0], _SIZES, within_shard_shuffle=-2,
                                  device="cpu")
    with pytest.raises(ValueError, match="within_shard_shuffle"):
        expand_shard_indices_cpu([0], _SIZES, within_shard_shuffle=-2)
    for bad in ([5], [-1], [0, 7]):
        with pytest.raises(ValueError, match="shard ids"):
            expand_shard_indices_cuda(bad, _SIZES, device="cpu")
        with pytest.raises(ValueError, match="shard ids"):
            expand_shard_indices_cpu(bad, _SIZES)
    with pytest.raises(ValueError, match="shard sizes"):
        expand_shard_indices_cuda([0], [2**31], device="cpu")
    with pytest.raises(ValueError, match="device"):
        expand_shard_indices_cuda([0], _SIZES, device="meta")


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the CPU-only refusals do not apply")


def test_every_cuda_entry_raises_without_gpu(no_gpu):
    calls = [
        lambda: expand_shard_indices_cuda([2, 0, 3], _SIZES),
        lambda: expand_shard_indices_cuda([2, 0, 3], _SIZES, device="cuda:0"),
        lambda: PartialShuffleShardSampler(64, num_replicas=2, rank=0),
        lambda: PartialShuffleShardSampler.reshard_from_state_dict(
            PartialShuffleShardSampler(64, num_replicas=2, rank=0,
                                       backend="cpu").state_dict(),
            num_replicas=3, rank=0),
    ]
    for call in calls:
        with pytest.raises(CudaUnavailableError):
            call()


def test_cpu_routes_launch_no_kernel():
    ck.reset_launches()
    expand_shard_indices_cuda([2, 0, 3], _SIZES, device="cpu")
    s = PartialShuffleShardSampler(64, num_replicas=2, rank=0, backend="cpu")
    s.device_epoch_indices([3] * 64)
    assert not any(ck.launches.values())
