"""Index spaces n >= 2^31 (the 10B-sample Llama-3 pretrain config) through
the port's wide routes on the CPU: ``epoch_indices_cuda(device="cpu")``
and the plain versions of the two wide kernels, held bit-exact
(tolerance 0) against the JAX package's numpy reference and its
``epoch_indices_jax``.  JAX needs x64 for uint64 positions, which the
conftest does not enable, so the JAX side runs in one x64 subprocess.
World is large at every shape, so each rank has few lanes.
"""

import json
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from partiallyshuffledistributedsampler_tpu.ops import cpu as jcpu
from partiallyshuffledistributedsampler_tpu_torch.ops import (
    core,
    cuda,
    cuda_kernel as ck,
)

TEN_B = 10_000_000_000
N31 = 2**31 + 5000
SEED, EPOCH = 42, 3
#: (id, n, window, world, rank, law kwargs)
CASES = [
    ("2^31+5000-w8192-r0", N31, 8192, 8192, 0, {}),        # m = 1
    ("2^31+5000-w8192-r4999", N31, 8192, 8192, 4999, {}),  # one tail lane
    ("2^31+5000-w4096-r0", N31, 8192, 4096, 0, {}),        # m = 2
    ("2^31+5000-w4096-r4095", N31, 8192, 4096, 4095, {}),
    ("10B-w8192-r0", TEN_B, 8192, 8192, 0, {}),
    ("10B-w8192-r8191", TEN_B, 8192, 8192, 8191, {}),
    ("10B-w8192-blocked-r8191", TEN_B, 8192, 8192, 8191,
     {"partition": "blocked"}),
    ("10B-w8192-droplast-r5", TEN_B, 8192, 8192, 5, {"drop_last": True}),
]
#: random-access probes at 10B, past one epoch too (taken mod n)
PROBES = np.random.default_rng(7).integers(0, 2 * TEN_B, size=2048)

_JAX_X64 = textwrap.dedent("""
    import json, os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    import partiallyshuffledistributedsampler_tpu as psds
    psds.enable_big_index_space()
    from partiallyshuffledistributedsampler_tpu.ops import xla
    cases, probes, out = json.loads(sys.argv[1]), sys.argv[2], sys.argv[3]
    seed, epoch = int(sys.argv[4]), int(sys.argv[5])
    rows = {}
    for cid, n, w, world, rank, kw in cases:
        rows[cid] = np.asarray(psds.epoch_indices_jax(
            n, w, seed, epoch, rank, world, **kw))
    rows["probes"] = np.asarray(xla.stream_indices_at_jax(
        np.load(probes), 10_000_000_000, 8192, seed, epoch))
    np.savez(out, **rows)
""")


@pytest.fixture(scope="module")
def jax_x64(tmp_path_factory):
    """The JAX package's outputs at every case, from one x64 process."""
    d = tmp_path_factory.mktemp("jax_x64")
    np.save(d / "probes.npy", PROBES)
    res = subprocess.run(
        [sys.executable, "-c", _JAX_X64, json.dumps(CASES),
         str(d / "probes.npy"), str(d / "out.npz"), str(SEED), str(EPOCH)],
        capture_output=True, text=True, timeout=600,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("cid,n,window,world,rank,kw", CASES,
                         ids=[c[0] for c in CASES])
def test_wide_routes_match_jax_x64(cid, n, window, world, rank, kw,
                                   jax_x64):
    want = jax_x64[cid]
    assert want.dtype == np.int64
    np.testing.assert_array_equal(
        want, jcpu.epoch_indices_np(n, window, SEED, EPOCH, rank, world,
                                    **kw))
    ck.reset_launches()
    for amortize in (True, False):
        got = cuda.epoch_indices_cuda(n, window, SEED, EPOCH, rank, world,
                                      amortize=amortize, device="cpu", **kw)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
    assert not any(ck.launches.values())
    # the wide wrappers route a CPU device to their plain versions
    np.testing.assert_array_equal(
        ck.index_general_wide(n, window, SEED, EPOCH, rank, world,
                              device="cpu", **kw).numpy(), want)
    if cuda._amortized_applicable(n, window, world, True,
                                  kw.get("partition", "strided")):
        got = ck.index_amortized_wide(n, window, SEED, EPOCH, rank, world,
                                      device="cpu", **kw)
        np.testing.assert_array_equal(got.numpy(), want)


def test_wide_cases_reach_the_high_index_space(jax_x64):
    assert max(int(jax_x64[c[0]].max()) for c in CASES) > 2**33
    # the amortized route serves the strided cases, the general the rest
    for _cid, n, window, world, _rank, kw in CASES:
        assert cuda._amortized_applicable(
            n, window, world, True, kw.get("partition", "strided")
        ) == (kw.get("partition") != "blocked")


def test_wide_stream_access_matches_jax_x64(jax_x64):
    got = cuda.stream_indices_at_cuda(PROBES, TEN_B, 8192, SEED, EPOCH,
                                      device="cpu")
    assert got.dtype == torch.int64 and int(got.max()) > 2**31
    np.testing.assert_array_equal(got.numpy(), jax_x64["probes"])
    np.testing.assert_array_equal(
        got.numpy(),
        jcpu.stream_indices_at_np(PROBES, TEN_B, 8192, SEED, EPOCH))


def test_wide_stream_access_reads_the_epoch():
    """Random access at lanes of rank 8191's 10B epoch equals the epoch."""
    rank, world = 8191, 8192
    ep = cuda.epoch_indices_cuda(TEN_B, 8192, SEED, EPOCH, rank, world,
                                 device="cpu")
    t = torch.tensor([0, 1, 1_220_702, ep.numel() - 1])
    got = cuda.stream_indices_at_cuda(rank + world * t, TEN_B, 8192, SEED,
                                      EPOCH, device="cpu")
    assert torch.equal(got, ep[t])


def test_wide_elastic_matches_numpy():
    layers = [(8192, 1_220_000)]
    chain, _remaining, ns = core.elastic_chain(TEN_B, layers, 4096)
    got = cuda.elastic_indices_cuda(TEN_B, 8192, SEED, EPOCH, 7, 4096, ns,
                                    chain, device="cpu")
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(
        got.numpy(),
        jcpu.elastic_indices_np(TEN_B, 8192, SEED, EPOCH, 7, 4096, layers))


def test_wide_and_narrow_wrappers_refuse_the_other_width():
    with pytest.raises(ValueError, match="wide"):
        ck.index_general(TEN_B, 8192, 0, 0, 0, 8192, device="cpu")
    with pytest.raises(ValueError, match="narrow"):
        ck.index_general_wide(10**6, 8192, 0, 0, 0, 8, device="cpu")
    with pytest.raises(ValueError, match="wide"):
        ck.index_amortized(TEN_B, 8192, 0, 0, 0, 8192, device="cpu")
    with pytest.raises(ValueError, match="narrow"):
        ck.index_amortized_wide(10**6, 8192, 0, 0, 0, 8, device="cpu")


def test_amortized_gate_in_the_wide_regime():
    ok = cuda._amortized_applicable
    assert ok(TEN_B, 8192, 256, True, "strided")     # 39M lanes a rank
    assert ok(TEN_B, 8192, 8, True, "strided")       # 1.25B lanes a rank
    assert not ok(TEN_B, 8192, 4, True, "strided")   # 2.5B lanes >= 2^31
    assert not ok(2**32 + 4097, 8192, 1, True, "strided")
