"""The port's non-uniform sampling (``sampling/``) on the CPU against the JAX
package's: the alias table field by field, the alias law on given ordinals
(``weighted_stream_at_cpu`` against the numpy form of
``weighted_stream_at_generic``), the rank's epoch and elastic streams
against ``weighted_epoch_indices_jax`` / ``weighted_elastic_indices_jax``
(the 64-bit cases in one x64 JAX subprocess, as the conftest keeps JAX at
32 bits), the three ``SamplingSpec`` modes (streams, wire form and
fingerprint string-equal, ``from_wire``, ``with_world``, adopted weights),
the dedup state carried across a snapshot, the warnings, and the uint64
modulus above 2^62.  The 'cuda' routes with ``device="cpu"`` run the
kernels' plain version.  Tolerance 0: the law is integer-exact.  The
kernels themselves are held on the card by ``tests/test_torch_port_gpu.py``.
"""

import json
import subprocess
import sys
import textwrap
import warnings

import numpy as np
import pytest
import torch

from partiallyshuffledistributedsampler_tpu.sampling import alias as JA
from partiallyshuffledistributedsampler_tpu.sampling import dedup as JD
from partiallyshuffledistributedsampler_tpu.sampling.spec import (
    SamplingSpec as JSampling,
)
from partiallyshuffledistributedsampler_tpu_torch import (
    CudaUnavailableError,
    PartialShuffleSpec,
    SamplingSpec,
)
from partiallyshuffledistributedsampler_tpu_torch.ops import (
    core,
    cuda_kernel as ck,
    fastdiv,
)
from partiallyshuffledistributedsampler_tpu_torch.sampling import alias as PA
from partiallyshuffledistributedsampler_tpu_torch.sampling import dedup as PD

_RNG = np.random.default_rng(9)
#: (id, sizes, weights, weight_kind): random integer weights of both kinds,
#: the degenerate tables, S = 1, 8, 9 and 300, a total past 2^31 after the
#: GCD, a source past 2^31
TABLES = [
    ("s3-source", (900, 600, 500), (5, 1, 2), "per_source"),
    ("s3-sample", (900, 600, 500), (5, 1, 2), "per_sample"),
    ("s1", (1000,), (7,), "per_source"),
    ("s8-random", tuple(int(x) for x in _RNG.integers(1, 5000, 8)),
     tuple(int(x) for x in _RNG.integers(0, 100, 8)), "per_source"),
    ("s9-random", tuple(int(x) for x in _RNG.integers(1, 5000, 9)),
     tuple(int(x) for x in _RNG.integers(0, 100, 9)), "per_sample"),
    ("s300", tuple(int(x) for x in _RNG.integers(1, 3000, 300)),
     tuple(int(x) for x in _RNG.integers(0, 1000, 300)), "per_source"),
    ("uniform", (300, 500, 700, 100), (3, 3, 3, 3), "per_source"),
    ("one-hot", (300, 500, 700, 100), (0, 0, 4, 0), "per_source"),
    ("total-past-2^31", (5000, 6000), (2**40 + 1, 3**20), "per_source"),
    ("source-past-2^31", (2**31 + 7, 1000, 2**32 + 5), (1, 2, 3),
     "per_source"),
]
_TABLE = {t[0]: t[1:] for t in TABLES}


def _tables(tid):
    sizes, weights, kind = _TABLE[tid]
    return (JA.build_alias_table(weights, kind, sizes),
            PA.build_alias_table(weights, kind, sizes), sizes)


def _fields(t):
    return (t.probs, t.alias, t.total, t.masses)


@pytest.mark.parametrize("tid", [t[0] for t in TABLES])
def test_alias_table_field_by_field(tid):
    jt, pt, _sizes = _tables(tid)
    assert _fields(pt) == _fields(jt)
    assert pt.key() == jt.key()


def test_alias_table_refusals_match():
    bad = [((), (), "per_source"), ((10, 0), (1, 1), "per_source"),
           ((10, 10), (1,), "per_source"), ((10, 10), (1, -1), "per_source"),
           ((10, 10), (0, 0), "per_source"), ((10, 10), (1, 1), "bogus"),
           ((1,) * 4097, (1,) * 4097, "per_source"),
           ((10, 10), (2**62, 2**62 + 1), "per_source")]
    for sizes, weights, kind in bad:
        with pytest.raises(ValueError) as jexc:
            JA.build_alias_table(weights, kind, sizes)
        with pytest.raises(ValueError) as pexc:
            PA.build_alias_table(weights, kind, sizes)
        assert str(pexc.value) == str(jexc.value)


def _ordinals():
    pos = _RNG.integers(0, 2**63, 2000, dtype=np.int64).astype(np.uint64)
    pos[:6] = [0, 1, 2**31 - 1, 2**32 - 1, 2**32, 2**64 - 1]
    pos[6:1000] %= np.uint64(2**32)
    return pos


@pytest.mark.parametrize("retry", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("tid", ["s3-source", "s9-random", "s300",
                                 "one-hot", "total-past-2^31",
                                 "source-past-2^31"])
def test_stream_at_matches_numpy(tid, retry):
    jt, pt, sizes = _tables(tid)
    pos = _ordinals()
    for seed, shuffle in ((0, True), (-12345, True), (2**40 + 3, False),
                          (2**64 - 1, True)):
        kw = dict(window=64, shuffle=shuffle, retry=retry)
        want = JA.weighted_stream_at_generic(np, pos, jt, sizes, seed, 5,
                                             **kw)
        got = PA.weighted_stream_at_cpu(pos, pt, sizes, seed, 5, **kw)
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want)
        # uint32 ordinals give the same ids as the same values in uint64
        pos32 = pos[6:1000].astype(np.uint32)
        np.testing.assert_array_equal(
            PA.weighted_stream_at_cpu(pos32, pt, sizes, seed, 5, **kw)
            .numpy(),
            JA.weighted_stream_at_generic(np, pos32, jt, sizes, seed, 5,
                                          **kw))


def test_stream_at_small_sources_high_rounds_and_signed_ordinals():
    jt, pt, sizes = _tables("s3-source")
    pos = _ordinals()
    for window, rounds in ((4096, 24), (7, 0), (64, 70), (1, 24)):
        kw = dict(window=window, rounds=rounds)
        np.testing.assert_array_equal(
            PA.weighted_stream_at_cpu(pos, pt, sizes, 3, 2, **kw).numpy(),
            JA.weighted_stream_at_generic(np, pos, jt, sizes, 3, 2, **kw))
    # an int64 tensor holds the uint64 bits: -1 is 2^64 - 1
    signed = torch.tensor([-1, 5], dtype=torch.int64)
    np.testing.assert_array_equal(
        PA.weighted_stream_at_cpu(signed, pt, sizes, 3, 2, window=64)
        .numpy(),
        JA.weighted_stream_at_generic(
            np, np.array([2**64 - 1, 5], dtype=np.uint64), jt, sizes, 3, 2,
            window=64))


def test_u64_modulus_above_2_62():
    xs = [0, 1, 2**62, 2**63 - 1, 2**63, 2**63 + 5, 2**64 - 2, 2**64 - 1,
          *(int(v) for v in _RNG.integers(0, 2**63, 200, dtype=np.int64)),
          *(int(v) + 2**63 for v in _RNG.integers(0, 2**63, 200,
                                                  dtype=np.int64))]
    t = torch.tensor([x - 2**64 if x >= 2**63 else x for x in xs],
                     dtype=torch.int64)
    for d in (2**63 - 1, 2**62 + 1, 2**62, 3 * 2**61 + 7, 10**18 + 9):
        for div in (d, torch.full_like(t, d)):
            q, r = core.u64_divmod(t, div)
            assert [v % 2**64 for v in q.tolist()] == [x // d for x in xs]
            assert r.tolist() == [x % d for x in xs]


@pytest.mark.parametrize("world", [2, 3, 4])
@pytest.mark.parametrize("partition", ["strided", "blocked"])
@pytest.mark.parametrize("drop_last", [False, True])
def test_epoch_and_elastic_match_jax(world, partition, drop_last):
    jt, pt, sizes = _tables("s9-random")
    kw = dict(epoch_samples=1001, window=64, partition=partition,
              drop_last=drop_last)
    layers = [(5, 70), (2, 30)]
    for rank in range(world):
        want = np.asarray(JA.weighted_epoch_indices_jax(
            jt, sizes, 11, 2, rank, world, **kw))
        np.testing.assert_array_equal(
            PA.weighted_epoch_indices_cpu(pt, sizes, 11, 2, rank, world,
                                          **kw).numpy(), want)
        # the card's entry point on the CPU runs the kernel's plain version
        np.testing.assert_array_equal(
            PA.weighted_epoch_indices_cuda(pt, sizes, 11, 2, rank, world,
                                           device="cpu", **kw).numpy(), want)
        want = JA.weighted_elastic_indices_jax(jt, sizes, 11, 2, rank, world,
                                               layers, **kw)
        np.testing.assert_array_equal(
            PA.weighted_elastic_indices_cpu(pt, sizes, 11, 2, rank, world,
                                            layers, **kw).numpy(), want)
        np.testing.assert_array_equal(
            PA.weighted_elastic_indices_cuda(pt, sizes, 11, 2, rank, world,
                                             layers, device="cpu",
                                             **kw).numpy(), want)


#: (id, table id, epoch_samples, world, rank, law kwargs, layers): the
#: cases that need JAX's x64 (a total or a source past 2^31, an epoch of
#: 2^31 draws or more)
X64_CASES = [
    ("total64", "total-past-2^31", 5000, 3, 2, {}, [(2, 1000)]),
    ("source64", "source-past-2^31", 5000, 4, 1,
     {"partition": "blocked"}, [(3, 500)]),
    ("source64-w8192", "source-past-2^31", 9000, 2, 0,
     {"window": 8192, "drop_last": True}, [(4, 700)]),
    ("epoch64", "s3-source", 2**31 + 10, 2**20, 5, {}, [(2**19, 3000)]),
    ("epoch64-blocked", "source-past-2^31", 2**31 + 10, 2**20, 2**20 - 1,
     {"partition": "blocked"}, [(2**19, 3000)]),
]

_JAX_X64 = textwrap.dedent("""
    import json, os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from partiallyshuffledistributedsampler_tpu.sampling import alias as A
    cases, out = json.loads(sys.argv[1]), sys.argv[2]
    rows = {}
    for cid, (sizes, weights, kind), T, world, rank, kw, layers in cases:
        t = A.build_alias_table(weights, kind, sizes)
        law = dict(epoch_samples=T, window=kw.pop("window", 64), **kw)
        rows[cid] = np.asarray(A.weighted_epoch_indices_jax(
            t, sizes, -77, 3, rank, world, **law))
        rows[cid + "/elastic"] = np.asarray(A.weighted_elastic_indices_jax(
            t, sizes, -77, 3, rank, world, layers, **law))
    np.savez(out, **rows)
""")


@pytest.fixture(scope="module")
def jax_x64(tmp_path_factory):
    """The JAX package's weighted streams at every x64 case, from one x64
    process."""
    d = tmp_path_factory.mktemp("sampling_x64")
    cases = [(cid, _TABLE[tid], T, world, rank, kw, layers)
             for cid, tid, T, world, rank, kw, layers in X64_CASES]
    res = subprocess.run(
        [sys.executable, "-c", _JAX_X64, json.dumps(cases),
         str(d / "out.npz")],
        capture_output=True, text=True, timeout=600,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("cid,tid,T,world,rank,kw,layers", X64_CASES,
                         ids=[c[0] for c in X64_CASES])
def test_x64_cases_match_jax(cid, tid, T, world, rank, kw, layers, jax_x64):
    _jt, pt, sizes = _tables(tid)
    kw = dict(kw)
    law = dict(epoch_samples=T, window=kw.pop("window", 64), **kw)
    got = PA.weighted_epoch_indices_cpu(pt, sizes, -77, 3, rank, world,
                                        **law)
    assert got.dtype == PA.out_dtype(sizes)
    np.testing.assert_array_equal(got.numpy(), jax_x64[cid])
    got = PA.weighted_elastic_indices_cuda(pt, sizes, -77, 3, rank, world,
                                           layers, device="cpu", **law)
    np.testing.assert_array_equal(got.numpy(), jax_x64[cid + "/elastic"])


def test_x64_cases_reach_the_wide_lanes(jax_x64):
    assert int(jax_x64["source64"].max()) > 2**31
    assert jax_x64["epoch64"].dtype == np.int32
    assert jax_x64["source64"].dtype == np.int64


# ------------------------------------------------------------------ specs
SIZES = (900, 600, 500)


def _spec_pair(mode, **kw):
    """The same sampling config in both packages: (jax spec, port spec)."""
    def build(cls, **extra):
        if mode == "weighted":
            return cls.weighted(SIZES, (5, 1, 2), epoch_samples=1001,
                                window=64, **kw, **extra)
        if mode == "prioritized":
            return cls.prioritized(SIZES, (1, 3, 1), epoch_samples=512,
                                   window=64, weight_kind="per_sample",
                                   **kw, **extra)
        if mode == "dedup":
            return cls.deduped(SIZES, epoch_samples=500, window=64, **kw,
                               **extra)
        return cls.deduped(SIZES, epoch_samples=500, window=64,
                           weights=(2, 1, 1),
                           dedup=dict(kind="bloom", bits=4096, hashes=3),
                           **kw, **extra)
    return build(JSampling, backend="cpu"), build(SamplingSpec,
                                                  backend="cpu")


MODES = ["weighted", "prioritized", "dedup", "dedup-bloom"]
SPEC_KW = [dict(world=3, seed=-7), dict(world=2, partition="blocked"),
           dict(world=4, drop_last=True, seed=2**40 + 1),
           dict(world=2, shuffle=False, rounds=9)]


@pytest.mark.parametrize("kw", SPEC_KW, ids=["strided", "blocked",
                                             "drop_last", "unshuffled"])
@pytest.mark.parametrize("mode", MODES)
def test_spec_streams_match_jax(mode, kw):
    j, p = _spec_pair(mode, **kw)
    assert p.num_samples() == j.num_samples()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # dedup saturation
        for epoch in (0, 1, 2):
            for rank in range(j.world):
                want = j.rank_indices(epoch, rank)
                got = p.rank_indices(epoch, rank)
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
                layers = [(j.world + 1, 40)]
                np.testing.assert_array_equal(
                    p.rank_indices(epoch, rank, layers=layers),
                    j.rank_indices(epoch, rank, layers=layers))


@pytest.mark.parametrize("mode", MODES)
def test_spec_wire_fingerprint_and_from_wire(mode):
    j, p = _spec_pair(mode, world=3, seed=5, partition="blocked")
    assert p.to_wire() == j.to_wire()
    for include_world in (True, False):
        assert (p.fingerprint(include_world=include_world)
                == j.fingerprint(include_world=include_world))
    # the port's generic from_wire dispatches the three modes
    q = PartialShuffleSpec.from_wire(j.to_wire(), backend="cpu")
    assert type(q) is SamplingSpec and q.fingerprint() == j.fingerprint()
    assert q == p
    w = p.with_world(5)
    jw = j.with_world(5)
    assert w.fingerprint() == jw.fingerprint() and w.world == 5
    assert w.fingerprint(include_world=False) == p.fingerprint(
        include_world=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for rank in (0, 4):
            np.testing.assert_array_equal(w.rank_indices(1, rank),
                                          jw.rank_indices(1, rank))
    assert p.with_world(3) is p


def test_spec_defaults_to_the_card():
    with pytest.raises(CudaUnavailableError):
        SamplingSpec.weighted(SIZES, (1, 1, 1), epoch_samples=10)
    with pytest.raises(CudaUnavailableError):
        PartialShuffleSpec.from_wire(
            JSampling.weighted(SIZES, (1, 1, 1), epoch_samples=10,
                               backend="cpu").to_wire())
    with pytest.raises(TypeError, match="use_pallas"):
        SamplingSpec.weighted(SIZES, (1, 1, 1), epoch_samples=10,
                              backend="cpu", use_pallas=True)


def test_spec_refusals_match():
    for build in (
        lambda cls: cls("bogus", source_sizes=SIZES, epoch_samples=5,
                        backend="cpu"),
        lambda cls: cls.weighted(SIZES, (0, 0, 0), epoch_samples=5,
                                 backend="cpu"),
        lambda cls: cls.weighted(SIZES, (1, 1, 1), epoch_samples=0,
                                 backend="cpu"),
        lambda cls: cls("weighted", source_sizes=SIZES, epoch_samples=5,
                        dedup={}, backend="cpu"),
        lambda cls: cls.deduped(SIZES, epoch_samples=5,
                                dedup=dict(kind="bogus"), backend="cpu"),
        lambda cls: cls.deduped(SIZES, epoch_samples=5,
                                dedup=dict(retries=-1), backend="cpu"),
        lambda cls: cls.deduped(SIZES, epoch_samples=5, dedup=dict(x=1),
                                backend="cpu"),
    ):
        with pytest.raises(ValueError) as jexc:
            build(JSampling)
        with pytest.raises(ValueError) as pexc:
            build(SamplingSpec)
        assert str(pexc.value) == str(jexc.value)
    j, p = _spec_pair("weighted", world=2)
    with pytest.raises(ValueError, match="rank"):
        p.rank_indices(0, 2)
    for spec in (j, p):
        with pytest.raises(ValueError, match="prioritized"):
            spec.with_stream_weights({1: (1, 1, 1)})
        with pytest.raises(ValueError, match="dedup"):
            spec.with_dedup_boundary(1, {"kind": "exact", "ids": []})
        assert spec.dedup_boundary_wire(3) is None


def test_prioritized_adopted_weights_match_jax():
    j, p = _spec_pair("prioritized", world=2, seed=3)
    adopted = {1: (9, 0, 1), 3: (1, 1, 7)}
    ja, pa = j.with_stream_weights(adopted), p.with_stream_weights(adopted)
    assert pa.stream_weights == ja.stream_weights
    assert pa.fingerprint() == p.fingerprint() == ja.fingerprint()
    for epoch in range(5):
        assert pa.weights_for(epoch) == ja.weights_for(epoch)
        assert pa.effective_weights(epoch) == ja.effective_weights(epoch)
        for rank in (0, 1):
            np.testing.assert_array_equal(pa.rank_indices(epoch, rank),
                                          ja.rank_indices(epoch, rank))
    # epoch 0 keeps the base table, epoch 1 draws under the adopted one
    np.testing.assert_array_equal(pa.rank_indices(0, 0), p.rank_indices(0, 0))
    assert not np.array_equal(pa.rank_indices(1, 0), p.rank_indices(1, 0))
    # pruning keeps the newest entry below the floor as the anchor
    jp = ja.with_stream_weights({5: (2, 2, 2)}, prune_below=4)
    pp = pa.with_stream_weights({5: (2, 2, 2)}, prune_below=4)
    assert pp.stream_weights == jp.stream_weights == {3: (1, 1, 7),
                                                      5: (2, 2, 2)}
    # with_world carries the adopted weights
    assert pa.with_world(3).stream_weights == adopted


def test_bad_adopted_weights_fall_back_to_uniform_with_the_warning():
    j, p = _spec_pair("prioritized", world=1)
    ja = j.with_stream_weights({1: (1, 1)})  # two weights for three sources
    pa = p.with_stream_weights({1: (1, 1)})
    with pytest.warns(RuntimeWarning) as jw:
        want = ja.rank_indices(1, 0)
    with pytest.warns(RuntimeWarning) as pw:
        got = pa.rank_indices(1, 0)
    np.testing.assert_array_equal(got, want)
    assert ([str(w.message) for w in pw]
            == [str(w.message) for w in jw
                if "UNIFORM" in str(w.message)])


@pytest.mark.parametrize("mode", ["dedup", "dedup-bloom"])
def test_dedup_state_carried_across_a_snapshot(mode):
    j, p = _spec_pair(mode, world=2, seed=4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        j.rank_indices(0, 0)  # folds epoch 0
        wire = j.dedup_boundary_wire(1)
        assert wire["epoch"] == 1
        resumed = SamplingSpec.from_wire(j.to_wire(), backend="cpu")
        resumed = resumed.with_dedup_boundary(wire["epoch"], wire["seen"])
        for epoch in (1, 2):
            for rank in (0, 1):
                np.testing.assert_array_equal(resumed.rank_indices(epoch,
                                                                   rank),
                                              j.rank_indices(epoch, rank))
        # the port's own boundary snapshot is the JAX package's
        p.rank_indices(0, 1)
        assert p.dedup_boundary_wire(1) == wire
        assert resumed.dedup_boundary_wire(1) == wire


def test_dedup_fold_and_saturation_warning_match_jax():
    sizes = (90, 60, 50)  # 200 ids: epochs 2 and 3 saturate
    jt = JA.build_alias_table((5, 1, 2), "per_source", sizes)
    pt = PA.build_alias_table((5, 1, 2), "per_source", sizes)
    for kind in ("exact", "bloom"):
        cfg = dict(kind=kind, bits=512, hashes=2, retries=2)
        jseen, pseen = JD.make_seen(cfg, 3), PD.make_seen(cfg, 3)
        for epoch in range(4):
            with warnings.catch_warnings(record=True) as jw:
                warnings.simplefilter("always")
                want = JD.fold_epoch(jt, sizes, 3, epoch, 90, jseen,
                                     window=16, retries=2)
            with warnings.catch_warnings(record=True) as pw:
                warnings.simplefilter("always")
                got = PD.fold_epoch(pt, sizes, 3, epoch, 90, pseen,
                                    window=16, retries=2, backend="cpu")
            np.testing.assert_array_equal(got, want)
            assert pseen.snapshot() == jseen.snapshot()
            assert ([str(w.message) for w in pw]
                    == [str(w.message) for w in jw])
        assert any("saturated" in str(w.message) for w in pw)


def test_dedup_candidates_route_and_refusals():
    _jt, pt, sizes = _tables("s3-source")
    cand = PD.fold_candidates(pt, sizes, 1, 0, 300, window=64, retries=3,
                              backend="cpu")
    assert cand.shape == (4, 300)
    for r in range(4):
        np.testing.assert_array_equal(
            cand[r], PA.weighted_stream_at_cpu(np.arange(300), pt, sizes, 1,
                                               0, window=64, retry=r))
    with pytest.raises(CudaUnavailableError):
        PD.fold_candidates(pt, sizes, 1, 0, 300, window=64)
    with pytest.raises(ValueError):
        PD.restore_seen({"kind": "bogus"}, 0)
    with pytest.raises(ValueError):
        PD.BloomSeen(4, 1, 0)


# ----------------------------------------------------- the kernel wrappers
def test_kernel_wrappers_route_the_cpu_to_the_plain_version():
    _jt, pt, sizes = _tables("s9-random")
    ck.reset_launches()
    ns, _ = core.shard_sizes(1001, 3, False)
    kw = dict(window=64, epoch_samples=1001, rank=2, world=3,
              num_samples=ns, device="cpu")
    got = ck.weighted_stream(pt, sizes, 5, 1, **kw)
    want = PA.weighted_epoch_indices_cpu(pt, sizes, 5, 1, 2, 3,
                                         epoch_samples=1001, window=64)
    assert torch.equal(got, want)
    # a W1-style ordinal through the wide wrapper equals the narrow one
    pos = core.rank_positions(1001, 2, 3, ns, "strided", False)
    assert torch.equal(ck.weighted_stream_wide(pt, sizes, 5, 1,
                                               positions=pos, window=64),
                       want)
    assert not any(ck.launches.values())
    with pytest.raises(ValueError, match="wide"):
        ck.weighted_stream(pt, sizes, 5, 1, **dict(kw, epoch_samples=2**31))
    with pytest.raises(ValueError, match="narrow"):
        ck.weighted_stream_wide(pt, sizes, 5, 1, **kw)
    with pytest.raises(ValueError, match="not both"):
        ck.weighted_stream_wide(pt, sizes, 5, 1, positions=pos, rank=0,
                                window=64)
    with pytest.raises(ValueError, match="columns"):
        ck.weighted_stream(PA.build_alias_table((1, 1), "per_source",
                                                (5, 5)), sizes, 5, 1, **kw)
    with pytest.raises(ValueError, match="window"):
        ck.weighted_stream(pt, sizes, 5, 1, **dict(kw, window=0))
    with pytest.raises(CudaUnavailableError):
        ck.weighted_stream(pt, sizes, 5, 1, **dict(kw, device="cuda"))
    with pytest.raises(CudaUnavailableError):
        PA.weighted_stream_at_cuda(pos, pt, sizes, 5, 1, window=64)


@pytest.mark.parametrize("tid", ["s3-source", "s300", "total-past-2^31",
                                 "source-past-2^31"])
def test_device_alias_table_words(tid):
    """The kernel's table (``ck.weighted_plan``) column by column: the
    threshold, the alias with the seed-free source mix, and each source's
    size with a magic number that divides as ``//`` does."""
    _jt, pt, sizes = _tables(tid)
    words = ck.weighted_plan(pt, sizes, 64)
    assert words.size == ck.COL_WORDS * len(sizes)
    bits = 64 if max(sizes) > core.INT32_MAX else 32
    offs, _ = PA.source_offsets(sizes)
    for j, n in enumerate(sizes):
        w = [int(v) for v in words[j * ck.COL_WORDS:(j + 1) * ck.COL_WORDS]]
        assert w[0] == pt.probs[j]
        assert w[1] & 0xFFFFFFFF == pt.alias[j]
        assert w[1] >> 32 == core.mix32(j ^ PA._C_SRC)
        assert (w[2], w[5], w[6]) == (n, offs[j], (n // 64) * 64)
        magic = (w[3], w[4] & 0xFF, w[4] >> 8)
        for x in (0, 1, n - 1, n, 2**bits - 1, 2**(bits - 1) + 12345):
            assert fastdiv.divide(x, magic, bits) == x // n
