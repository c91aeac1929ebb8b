"""The port's ``PartialShuffleSpec`` and ``StreamSpec`` on the CPU against
the JAX package's: every rank's stream (full epochs and §6 elastic
remainders) for plain, mixture and shard specs and both stream bases,
``rank_unit_sizes``, ``num_samples``, the wire form and fingerprint
(string-equal, with and without the world), ``from_wire`` of the other
package's wire, ``with_world`` and re-weighted streams.  Tolerance 0: the
law is integer-exact.  The 'cuda' routes are held against the 'cpu' ones
on the card by ``tests/test_torch_port_gpu.py``.
"""

import json

import numpy as np
import pytest

from partiallyshuffledistributedsampler_tpu.ops import mixture as JM
from partiallyshuffledistributedsampler_tpu.sampling.spec import SamplingSpec
from partiallyshuffledistributedsampler_tpu.service.spec import (
    PartialShuffleSpec as JSpec,
)
from partiallyshuffledistributedsampler_tpu.streaming import (
    StreamSpec as JStream,
)
from partiallyshuffledistributedsampler_tpu_torch import (
    CudaUnavailableError,
    MixtureSpec,
    PartialShuffleSpec,
    StreamSpec,
)
from partiallyshuffledistributedsampler_tpu_torch import (
    SamplingSpec as PortSamplingSpec,
)
from partiallyshuffledistributedsampler_tpu_torch.streaming import (
    WEIGHTS_RETAIN,
)

MIX = ([200, 100, 300], [3, 1, 2], dict(windows=16, block=30))
SHARD_SIZES = np.random.default_rng(3).integers(8, 20, 40)


def _mix(pkg_mixture_spec):
    sizes, weights, kw = MIX
    return pkg_mixture_spec(sizes, weights, **kw)


def _pair(kind, **kw):
    """The same config in both packages: (jax spec, port spec)."""
    if kind == "plain":
        n, window = kw.pop("n", 1000), kw.pop("window", 64)
        return (JSpec.plain(n, window=window, backend="cpu", **kw),
                PartialShuffleSpec.plain(n, window=window, backend="cpu",
                                         **kw))
    if kind == "mixture":
        return (JSpec.mixture(_mix(JM.MixtureSpec), backend="cpu", **kw),
                PartialShuffleSpec.mixture(_mix(MixtureSpec), backend="cpu",
                                           **kw))
    if kind == "shard":
        return (JSpec.shard(SHARD_SIZES, backend="cpu", **kw),
                PartialShuffleSpec.shard(SHARD_SIZES, backend="cpu", **kw))
    if kind == "stream_plain":
        h, window = kw.pop("horizon", 500), kw.pop("window", 32)
        return (JStream.plain_stream(h, window=window, backend="cpu", **kw),
                StreamSpec.plain_stream(h, window=window, backend="cpu",
                                        **kw))
    h = kw.pop("horizon", 400)
    return (JStream.mixture_stream(h, mixture=_mix(JM.MixtureSpec),
                                   backend="cpu", **kw),
            StreamSpec.mixture_stream(h, mixture=_mix(MixtureSpec),
                                      backend="cpu", **kw))


#: (kind, kwargs, layers): every spec kind and law flag, each with a §6
#: cascade valid for it (consumed in its base units)
CASES = [
    ("plain", dict(world=4, seed=7), [(3, 40)]),
    ("plain", dict(n=530, window=32, world=2), [(3, 40), (5, 7)]),
    ("plain", dict(world=3, drop_last=True, seed=2), [(4, 100)]),
    ("plain", dict(world=4, partition="blocked", rounds=5), [(2, 300)]),
    ("plain", dict(world=2, order_windows=False, seed=9), [(3, 40)]),
    ("plain", dict(world=2, shuffle=False), [(3, 40)]),
    ("plain", dict(n=1000, window=1000, world=1, seed=2**40 + 3),
     [(2, 200)]),
    ("mixture", dict(world=2, seed=4), [(3, 40)]),
    ("mixture", dict(world=3, epoch_samples=700), [(2, 100)]),
    ("mixture", dict(world=2, partition="blocked", drop_last=True),
     [(4, 20)]),
    ("shard", dict(world=2, window=8, seed=5), [(3, 4)]),
    ("shard", dict(world=3, window=8, within_shard_shuffle=False),
     [(2, 5)]),
    ("shard", dict(world=2, window=4, within_shard_shuffle=3, seed=1),
     [(3, 4)]),
    ("stream_plain", dict(world=2, seed=3), [(3, 40)]),
    ("stream_plain", dict(world=4, horizon=333, drop_last=True),
     [(2, 50)]),
    ("stream_mixture", dict(world=2, seed=8), [(3, 40)]),
]


def _case_id(c):
    kind, kw, _ = c
    return kind + "-" + "-".join(f"{k}{v}" for k, v in kw.items())


@pytest.fixture(params=CASES, ids=_case_id)
def case(request):
    kind, kw, layers = request.param
    j, p = _pair(kind, **dict(kw))
    return j, p, layers


def test_wire_and_fingerprint_string_equal(case):
    j, p, _ = case
    assert p.to_wire() == j.to_wire()
    assert json.dumps(p.to_wire()) == json.dumps(j.to_wire())
    assert p.fingerprint() == j.fingerprint()
    assert (p.fingerprint(include_world=False)
            == j.fingerprint(include_world=False))
    assert p.mode == j.mode


def test_rank_indices_every_rank(case):
    j, p, _ = case
    epochs = (0, 1, 2) if p.mode == "stream" else (0, 3)
    for epoch in epochs:
        for rank in range(p.world):
            got = p.rank_indices(epoch, rank)
            want = np.asarray(j.rank_indices(epoch, rank))
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_rank_indices_elastic_every_rank(case):
    j, p, layers = case
    for rank in range(p.world):
        got = p.rank_indices(2, rank, layers=layers)
        want = np.asarray(j.rank_indices(2, rank, layers=layers))
        np.testing.assert_array_equal(got, want)


def test_num_samples_and_unit_sizes(case):
    j, p, layers = case
    for rank in range(p.world):
        assert p.num_samples(rank) == j.num_samples(rank)
        for ly in (None, layers):
            a = p.rank_unit_sizes(1, rank, layers=ly)
            b = j.rank_unit_sizes(1, rank, layers=ly)
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, np.asarray(b))


def test_from_wire_across_packages(case):
    j, p, _ = case
    wire = json.loads(json.dumps(j.to_wire()))  # as it crosses a socket
    back = PartialShuffleSpec.from_wire(wire, backend="cpu")
    assert type(back) is type(p)
    assert back == p and back.fingerprint() == j.fingerprint()
    np.testing.assert_array_equal(back.rank_indices(1, 0),
                                  np.asarray(j.rank_indices(1, 0)))
    theirs = JSpec.from_wire(json.loads(json.dumps(p.to_wire())))
    assert theirs.fingerprint() == p.fingerprint()


def test_with_world(case):
    j, p, _ = case
    assert p.with_world(p.world) is p
    pw, jw = p.with_world(5), j.with_world(5)
    assert pw.fingerprint() == jw.fingerprint()
    assert (pw.fingerprint(include_world=False)
            == p.fingerprint(include_world=False))
    assert pw.backend == "cpu"
    for rank in (0, 4):
        np.testing.assert_array_equal(pw.rank_indices(1, rank),
                                      np.asarray(jw.rank_indices(1, rank)))


def test_reweighted_mixture_stream():
    j, p = _pair("stream_mixture", world=2, seed=5)
    assert WEIGHTS_RETAIN == 8
    assert p.weights_for(3) == j.weights_for(3) == (3, 1, 2)
    w = {1: (1, 1, 5), 3: [2, 7, 1]}
    pj, pp = j.with_stream_weights(w), p.with_stream_weights(w)
    assert pp.stream_weights == pj.stream_weights
    assert pp.fingerprint() == p.fingerprint() == pj.fingerprint()
    for g in range(5):
        assert pp.weights_for(g) == pj.weights_for(g)
        for rank in (0, 1):
            np.testing.assert_array_equal(
                pp.rank_indices(g, rank), np.asarray(pj.rank_indices(g, rank)))
    # re-weighting moves the stream, never the partition sizes
    assert not np.array_equal(pp.rank_indices(1, 0), p.rank_indices(1, 0))
    assert pp.num_samples(0) == p.num_samples(0)
    pruned_p = pp.with_stream_weights({6: (4, 4, 4)}, prune_below=5)
    pruned_j = pj.with_stream_weights({6: (4, 4, 4)}, prune_below=5)
    assert pruned_p.stream_weights == pruned_j.stream_weights
    assert pruned_p.weights_for(5) == pruned_j.weights_for(5) == (2, 7, 1)
    # the weights travel across a reshard, not the wire
    moved = pp.with_world(3)
    assert moved.stream_weights == pp.stream_weights
    np.testing.assert_array_equal(moved.rank_indices(1, 2), np.asarray(
        pj.with_world(3).rank_indices(1, 2)))
    assert j.with_stream_weights(w).weights_for(0) == p.weights_for(0)


def test_stream_horizons_and_plain_weights():
    j, p = _pair("stream_plain", world=2)
    for appended in (0, 499, 500, 1234):
        assert p.eligible_horizons(appended) == j.eligible_horizons(appended)
    assert p.weights_for(3) is None and j.weights_for(3) is None
    idx = np.concatenate([p.rank_indices(2, r) for r in (0, 1)])
    np.testing.assert_array_equal(np.sort(idx), np.arange(1000, 1500))


def test_refusals_match_the_jax_spec():
    bad = [
        dict(mode="nope", n=10, window=2),
        dict(mode="plain", n=10, window=2, world=0),
        dict(mode="plain", window=2),
        dict(mode="mixture"),
        dict(mode="shard"),
        dict(mode="plain", n=10, window=2, bogus=1),
    ]
    for kw in bad:
        kw = dict(kw)
        mode = kw.pop("mode")
        with pytest.raises(Exception) as ej:
            JSpec(mode, backend="cpu", **kw)
        with pytest.raises(type(ej.value)):
            PartialShuffleSpec(mode, backend="cpu", **kw)
    for cls in (JSpec, PartialShuffleSpec):
        spec = cls.plain(100, window=8, world=2, backend="cpu")
        with pytest.raises(ValueError, match="rank"):
            spec.rank_indices(0, 2)
    with pytest.raises(ValueError):
        StreamSpec.plain_stream(0, window=8, backend="cpu")
    with pytest.raises(ValueError, match="window"):
        StreamSpec(horizon=10, backend="cpu")


def test_port_specific_refusals():
    with pytest.raises(TypeError, match="use_pallas"):
        PartialShuffleSpec.plain(100, window=8, backend="cpu",
                                 use_pallas=True)
    # 'auto' resolves host-side, to 'native' where the C++ build loads
    for backend in ("auto", "native"):
        assert PartialShuffleSpec.plain(
            100, window=8, backend=backend).backend == "native"
    with pytest.raises(ValueError, match="JAX package"):
        PartialShuffleSpec.plain(100, window=8, backend="xla")
    # the default backend is the card's, and there is none here
    with pytest.raises(CudaUnavailableError):
        PartialShuffleSpec.plain(100, window=8)
    with pytest.raises(CudaUnavailableError):
        StreamSpec.plain_stream(100, window=8)


@pytest.mark.parametrize("mode", ["weighted", "prioritized", "dedup"])
def test_sampling_wire_is_refused_by_name(mode):
    """The three sampling wire modes of the JAX package, once refused, now
    come back from the generic ``from_wire`` as the port's ``SamplingSpec``
    with the same fingerprint and streams."""
    sizes = (900, 600, 500)
    if mode == "weighted":
        s = SamplingSpec.weighted(sizes, (5, 1, 2), epoch_samples=512,
                                  window=64, world=2)
    elif mode == "prioritized":
        s = SamplingSpec.prioritized(sizes, (1, 1, 1), epoch_samples=512,
                                     window=64, world=2)
    else:
        s = SamplingSpec.deduped(sizes, epoch_samples=512, window=64,
                                 world=2)
    wire = s.to_wire()
    assert wire["mode"] == mode
    port = PartialShuffleSpec.from_wire(wire, backend="cpu")
    assert type(port) is PortSamplingSpec
    assert port.fingerprint() == s.fingerprint()
    for rank in (0, 1):
        np.testing.assert_array_equal(port.rank_indices(1, rank),
                                      s.rank_indices(1, rank))


def test_mixture_builder_takes_a_key():
    _j, p = _pair("mixture", world=2)
    q = PartialShuffleSpec.mixture(_mix(MixtureSpec).key(), world=2,
                                   backend="cpu")
    assert q == p and q.mixture_spec.key() == p.mixture_spec.key()
