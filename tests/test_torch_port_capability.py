"""The port's ``capability/`` on the CPU against the JAX package's: the
signed ``EpochCapability`` (canonical bytes, HMAC signature and wire dict
byte-equal for the same fields, with and without the additive
``stream_weights``/``cell``/``kid``; each package's wire verifies in the
other; the refusals of the JAX token tests), and the membership-trail
replay (``membership_stream``, ``orphan_slice``, ``replay_trail``) for
plain, mixture, shard, sampling and stream specs on the port's 'cpu' and
'native' backends: non-elastic epochs, orphans on rank 0, two- and
three-membership trails and a rank vacated by a shrink.  Tolerance 0: the
law is integer-exact and the signatures are bytes.  The 'cuda' replay is
held against 'cpu' on the card by ``tests/test_torch_port_gpu.py``.
"""

import numpy as np
import pytest

from partiallyshuffledistributedsampler_tpu import capability as JC
from partiallyshuffledistributedsampler_tpu.ops import mixture as JM
from partiallyshuffledistributedsampler_tpu.sampling.spec import (
    SamplingSpec as JSampling,
)
from partiallyshuffledistributedsampler_tpu.service.spec import (
    PartialShuffleSpec as JSpec,
)
from partiallyshuffledistributedsampler_tpu.streaming import (
    StreamSpec as JStream,
)
from partiallyshuffledistributedsampler_tpu_torch import (
    MixtureSpec,
    PartialShuffleSpec,
    SamplingSpec,
    StreamSpec,
)
from partiallyshuffledistributedsampler_tpu_torch import capability as PC

SECRET = b"psds-test-deployment-secret"
MIX = ([200, 100, 300], [3, 1, 2], dict(windows=16, block=30))
SHARD_SIZES = np.random.default_rng(3).integers(8, 20, 40)
SIZES, WEIGHTS = (200, 100, 300), (3, 1, 2)


# ---------------------------------------------------------------- the token
def _fields(rng, extra: str) -> dict:
    """One capability's fields drawn from ``rng``: 64-bit seeds (negative
    too), a cascade, orphans, a tenant; ``extra`` adds the additive
    fields."""
    world = int(rng.integers(1, 300))
    f = dict(
        fingerprint=f"{int(rng.integers(0, 2**63)):016x}",
        epoch=int(rng.integers(0, 2**33)),
        seed=int(rng.integers(-2**63, 2**63 - 1)),
        generation=int(rng.integers(0, 1000)),
        world=world,
        layers=tuple((int(rng.integers(1, 300)), int(rng.integers(0, 10**9)))
                     for _ in range(int(rng.integers(0, 4)))),
        elastic_epoch=(None if rng.random() < 0.5
                       else int(rng.integers(0, 100))),
        orphans=tuple({"epoch": int(rng.integers(0, 9)), "rank": 0,
                       "world": world, "lo": 0,
                       "hi": int(rng.integers(1, 99)),
                       "layers": [[4, int(rng.integers(0, 50))]]}
                      for _ in range(int(rng.integers(0, 3)))),
        tenant=None if rng.random() < 0.3 else f"t{int(rng.integers(1e9))}",
    )
    if "weights" in extra:
        f["stream_weights"] = tuple(int(x) for x in rng.integers(1, 99, 3))
    if "cell" in extra:
        f["cell"] = f"cell-{int(rng.integers(0, 9))}"
        f["kid"] = int(rng.integers(0, 2**31))
    return f


@pytest.mark.parametrize("extra", ["", "weights", "cell", "weights+cell"])
@pytest.mark.parametrize("draw", range(4))
def test_canonical_bytes_and_signature_equal(extra, draw):
    f = _fields(np.random.default_rng(100 + draw), extra)
    j, p = JC.EpochCapability(**f), PC.EpochCapability(**f)
    assert p.canonical() == j.canonical()
    assert p.body() == j.body()
    # absent additive fields stay out of the signed bytes in both
    for key in ("stream_weights", "cell", "kid"):
        assert (key in p.body()) == (key in j.body()) == (key in f)
    for secret in (SECRET, SECRET.decode()):
        js, ps = j.signed(secret), p.signed(secret)
        assert ps.sig == js.sig and len(ps.sig) == 64
        assert ps.to_wire() == js.to_wire()
        assert ps.tampered().sig == js.tampered().sig


@pytest.mark.parametrize("extra", ["", "weights+cell"])
def test_each_wire_verifies_in_the_other_package(extra):
    f = _fields(np.random.default_rng(7), extra)
    j = JC.EpochCapability(**f).signed(SECRET)
    p = PC.EpochCapability(**f).signed(SECRET)
    from_j = PC.EpochCapability.from_wire(j.to_wire())
    from_p = JC.EpochCapability.from_wire(p.to_wire())
    assert from_j.verify(SECRET) and from_p.verify(SECRET)
    assert from_j == p and from_p == j
    assert from_j.canonical() == j.canonical()
    # a tampered wire fails in the other package too
    assert not PC.EpochCapability.from_wire(j.tampered().to_wire()).verify(
        SECRET)
    assert not JC.EpochCapability.from_wire(p.tampered().to_wire()).verify(
        SECRET)


def test_token_refusals_match_the_jax_token():
    for C in (JC, PC):
        cap = C.EpochCapability(fingerprint="f" * 16, epoch=0, seed=7,
                                generation=0, world=2).signed(SECRET)
        assert cap.verify(SECRET)
        assert not cap.verify(b"some-other-deployment")
        assert not cap.tampered().verify(SECRET)
        assert not C.EpochCapability(fingerprint="f" * 16, epoch=0, seed=7,
                                     generation=0, world=2).verify(SECRET)
        with pytest.raises(C.CapabilityError):
            C.EpochCapability.from_wire({"epoch": "not-a-grant"})
        with pytest.raises(C.CapabilityError):
            C.EpochCapability.from_wire({"fingerprint": "f", "epoch": 0,
                                         "seed": 1, "generation": 0,
                                         "world": "x"})
        with pytest.raises(TypeError):
            C.secret_bytes(1234)
    assert PC.secret_bytes("abc") == JC.secret_bytes("abc") == b"abc"
    # the port's error is its own type (never the JAX package's)
    assert PC.CapabilityError is not JC.CapabilityError
    assert issubclass(PC.CapabilityError, RuntimeError)


def test_roundtrip_of_a_full_grant():
    cap = PC.EpochCapability(fingerprint="f" * 16, epoch=3, seed=7,
                             generation=2, world=4,
                             layers=((8, 46), (4, 23)), elastic_epoch=3,
                             orphans=({"epoch": 3},),
                             tenant="t-abc").signed(SECRET)
    back = PC.EpochCapability.from_wire(cap.to_wire())
    assert back == cap and back.verify(SECRET)
    assert cap.verify(SECRET.decode())


# ---------------------------------------------------------------- the replay
def _pair(kind: str, backend: str, world: int):
    """The same stream in both packages: (jax spec on 'cpu', port spec on
    ``backend``), and the (consumed, next consumed) of a 3-layer cascade
    valid for it, in its base units."""
    if kind == "plain":
        return (JSpec.plain(1000, window=64, seed=5, world=world),
                PartialShuffleSpec.plain(1000, window=64, seed=5,
                                         world=world, backend=backend),
                (40, 25))
    if kind == "mixture":
        sizes, weights, kw = MIX
        return (JSpec.mixture(JM.MixtureSpec(sizes, weights, **kw), seed=2,
                              world=world),
                PartialShuffleSpec.mixture(MixtureSpec(sizes, weights, **kw),
                                           seed=2, world=world,
                                           backend=backend),
                (40, 20))
    if kind == "shard":
        return (JSpec.shard(SHARD_SIZES, seed=4, world=world),
                PartialShuffleSpec.shard(SHARD_SIZES, seed=4, world=world,
                                         backend=backend),
                (3, 2))
    if kind == "stream":
        return (JStream.plain_stream(500, window=32, seed=6, world=world),
                StreamSpec.plain_stream(500, window=32, seed=6, world=world,
                                        backend=backend),
                (30, 20))
    if kind == "stream_mixture":
        sizes, weights, kw = MIX
        j = JStream.mixture_stream(400, mixture=JM.MixtureSpec(
            sizes, weights, **kw), seed=8, world=world)
        p = StreamSpec.mixture_stream(400, mixture=MixtureSpec(
            sizes, weights, **kw), seed=8, world=world, backend=backend)
        # a re-weighted horizon rides the trail in both
        return (j.with_stream_weights({1: (1, 1, 4)}),
                p.with_stream_weights({1: (1, 1, 4)}), (30, 20))
    mode = kind.split("_")[1]
    kw = dict(epoch_samples=600, seed=3, world=world, window=16)
    if mode == "dedup":
        # 250 draws an epoch: epochs 0 and 1 fold without saturating
        kw["epoch_samples"] = 250
        j = JSampling.deduped(SIZES, **kw)
        p = SamplingSpec.deduped(SIZES, backend=backend, **kw)
    else:
        j = getattr(JSampling, mode)(SIZES, WEIGHTS, **kw)
        p = getattr(SamplingSpec, mode)(SIZES, WEIGHTS, backend=backend,
                                        **kw)
    if mode == "prioritized":
        j = j.with_stream_weights({1: (1, 6, 2)})
        p = p.with_stream_weights({1: (1, 6, 2)})
    return j, p, (40, 20)


KINDS = ["plain", "mixture", "shard", "stream", "stream_mixture",
         "sampling_weighted", "sampling_prioritized", "sampling_dedup"]
BACKENDS = ["cpu", "native"]


def _same(got, want, label):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    assert np.array_equal(got, want), label


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kind", KINDS)
def test_membership_stream_every_rank(kind, backend):
    """Each membership's stream equals the JAX package's for every rank,
    plain and under a cascade, and the non-elastic replay collapses to
    it; a rank past the world (vacated by a shrink) gets nothing."""
    j, p, (c1, _) = _pair(kind, backend, 3)
    for epoch in (0, 1):
        for rank in range(3):
            for layers in ([], [(4, c1)]):
                want = JC.membership_stream(j, epoch, rank, 3, layers, ())
                got = PC.membership_stream(p, epoch, rank, 3, layers, ())
                _same(got, want, (kind, epoch, rank, layers))
            _same(PC.replay_trail(p, epoch, rank=rank, world=3, layers=[],
                                  orphans=()),
                  PC.membership_stream(p, epoch, rank, 3, [], ()),
                  (kind, "non-elastic"))
    for rank, world in ((3, 3), (5, 2), (None, 3), (0, None)):
        got = PC.membership_stream(p, 0, rank, world, [], ())
        assert got.dtype == np.int64 and len(got) == 0
        _same(got, JC.membership_stream(j, 0, rank, world, [], ()),
              (kind, "vacated"))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kind", KINDS)
def test_orphans_prepend_on_rank_zero(kind, backend):
    j, p, (c1, _) = _pair(kind, backend, 2)
    orphans = (
        {"epoch": 1, "rank": 3, "world": 4, "lo": 2, "hi": 9,
         "layers": []},
        {"epoch": 1, "rank": 1, "world": 3, "lo": 0, "hi": 5,
         "layers": [[4, c1]]},
        {"epoch": 0, "rank": 0, "world": 4, "lo": 0, "hi": 4},  # other epoch
    )
    for o in orphans:
        _same(PC.orphan_slice(p, o), JC.orphan_slice(j, o), (kind, o))
    for rank in range(2):
        want = JC.membership_stream(j, 1, rank, 2, [], orphans)
        got = PC.membership_stream(p, 1, rank, 2, [], orphans)
        _same(got, want, (kind, rank))
    plain = PC.membership_stream(p, 1, 0, 2, [], ())
    assert len(got) == len(PC.membership_stream(p, 1, 1, 2, [], ()))
    assert len(PC.membership_stream(p, 1, 0, 2, [], orphans)) \
        == len(plain) + 7 + 5


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kind", KINDS)
def test_replay_trail_two_and_three_memberships(kind, backend):
    """World 4 -> 3 -> 2 mid-epoch: each membership contributes the prefix
    it delivered, the current one its remainder, rank 0 its orphans; a
    rank vacated by the shrink contributes only its prefixes."""
    j, p, (c1, c2) = _pair(kind, backend, 2)
    epoch = 1
    orphans = ({"epoch": 1, "rank": 2, "world": 3, "lo": 1, "hi": 6,
                "layers": [[4, c1]]},)
    for rank in range(4):
        m1 = {"rank": rank, "world": 4, "layers": [], "orphans": (),
              "samples": 11 + rank}
        m2 = {"rank": rank, "world": 3, "layers": [[4, c1]],
              "orphans": orphans if rank == 0 else (), "samples": 7}
        for trail, layers in (((m1,), [(4, c1)]),
                              ((m1, m2), [(4, c1), (3, c2)])):
            kw = dict(rank=rank if rank < 2 else None, world=2,
                      layers=layers, orphans=orphans if rank == 0 else (),
                      elastic_epoch=epoch, trail=trail)
            want = JC.replay_trail(j, epoch, **kw)
            got = PC.replay_trail(p, epoch, **kw)
            _same(got, want, (kind, rank, len(trail)))
            prefixes = sum(min(m["samples"], len(PC.membership_stream(
                p, epoch, m["rank"], m["world"], m["layers"],
                m["orphans"]))) for m in trail)
            assert len(got) >= prefixes
            # another epoch than the elastic one is one plain stream
            other = dict(kw, elastic_epoch=epoch + 1)
            _same(PC.replay_trail(p, epoch, **other),
                  JC.replay_trail(j, epoch, **other), (kind, "other epoch"))
    # nothing delivered and nothing left: an empty int64 stream
    empty = PC.replay_trail(p, epoch, rank=None, world=2, layers=[],
                            orphans=(), elastic_epoch=epoch, trail=())
    assert empty.dtype == np.int64 and len(empty) == 0


def test_replay_rides_a_capability_across_packages():
    """A grant signed by the JAX package, verified by the port, replays
    to the JAX package's stream: the capability path end to end."""
    j, p, (c1, _) = _pair("mixture", "cpu", 2)
    cap = JC.EpochCapability(
        fingerprint=j.fingerprint(include_world=False), epoch=1, seed=j.seed,
        generation=3, world=2, layers=((4, c1),), elastic_epoch=1,
        orphans=({"epoch": 1, "rank": 3, "world": 4, "lo": 0, "hi": 5},),
        tenant="t0").signed(SECRET)
    got_cap = PC.EpochCapability.from_wire(cap.to_wire())
    assert got_cap.verify(SECRET)
    assert got_cap.fingerprint == p.fingerprint(include_world=False)
    trail = ({"rank": 0, "world": 4, "layers": [], "orphans": (),
              "samples": 9},)
    for rank in range(2):
        kw = dict(rank=rank, world=got_cap.world,
                  layers=[list(x) for x in got_cap.layers],
                  orphans=got_cap.orphans,
                  elastic_epoch=got_cap.elastic_epoch, trail=trail)
        _same(PC.replay_trail(p, got_cap.epoch, **kw),
              JC.replay_trail(j, cap.epoch, **kw), rank)
