"""The CUDA sources of the weighted and positions kernels, compiled for the
host and run through their wrappers on CPU tensors, against the plain
versions.

A CUDA kernel has no interpret mode, so the card tests
(``tests/test_torch_port_gpu.py``) are the kernels' judges.  This file
reads the same sources a second way: ``g++`` compiles
``csrc/sampling_kernels.cu`` and ``csrc/index_kernels.cu`` against a small
host header that stands in for the CUDA builtins (one block of one
thread: every launch runs its grid-stride loop over all lanes in one
call; shared memory is static storage), with the ``<<<...>>>`` launch
syntax stripped.  The wrappers in ``ops/cuda_kernel.py`` then call that
library as they call the card's, and the output is held against the
plain version (tolerance 0): the lane arithmetic, the table layout, the
argument order of the C ABI and the chain composition of
``csrc/chain.cuh``.  What only the card shows (the real grid, warps,
memory spaces) stays with the card tests.  Skips where there is no g++.
"""

import ctypes
import re
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

from partiallyshuffledistributedsampler_tpu_torch.ops import core
from partiallyshuffledistributedsampler_tpu_torch.ops import (
    cuda_kernel as ck,
)
from partiallyshuffledistributedsampler_tpu_torch.sampling import alias as A

#: the CUDA builtins the two sources use, for one thread of one block
_HOST_CUDA_H = r"""
#pragma once
#include <cstddef>
#include <cstdint>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(x)
#define __shared__ static
#define __align__(x)
struct host_dim3 { unsigned x, y, z; };
static host_dim3 threadIdx{0, 0, 0}, blockIdx{0, 0, 0};
static host_dim3 blockDim{1, 1, 1}, gridDim{1, 1, 1};
typedef void *cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int *) { return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int *, cudaDeviceAttr, int) {
  return cudaSuccess;
}
template <class T>
cudaError_t cudaFuncSetAttribute(T, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline uint32_t __umulhi(uint32_t a, uint32_t b) {
  return (uint32_t)(((uint64_t)a * b) >> 32);
}
inline uint64_t __umul64hi(uint64_t a, uint64_t b) {
  return (uint64_t)(((unsigned __int128)a * b) >> 64);
}
template <class T> T __ldg(const T *p) { return *p; }
inline void __syncthreads() {}
"""


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """``{name: path}`` of the two sources built for the host."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel sources for the host")
    d = tmp_path_factory.mktemp("host_kernels")
    (d / "cuda_runtime.h").write_text(_HOST_CUDA_H)
    for header in ck._HEADERS:
        shutil.copy(header, d)
    out = {}
    for name in ("sampling", "index"):
        src = open(ck._SOURCES[name]).read()
        src = re.sub(r"<<<[^>]*>>>", "", src)
        src = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                     r"static \1 \2[1 << 16];", src)
        cpp, so = d / f"{name}.cpp", d / f"lib{name}.so"
        cpp.write_text(src)
        res = subprocess.run(
            [gxx, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{d}",
             "-o", str(so), str(cpp)],
            capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr[-3000:]
        out[name] = str(so)
    return out


@pytest.fixture
def host_kernels(host_libs, monkeypatch):
    """The wrappers routed to the host build: a CPU tensor takes the
    kernel's path, and the launch counters and loaded libraries are this
    test's own."""
    monkeypatch.setattr(ck, "_libs", {})
    monkeypatch.setattr(ck, "launches", dict.fromkeys(ck.launches, 0))
    monkeypatch.setattr(ck, "build", lambda: dict(host_libs))
    monkeypatch.setattr(ck, "device_kind", lambda device: "cuda")
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    assert isinstance(ck._load("sampling"), ctypes.CDLL)
    return ck


_RNG = np.random.default_rng(23)
#: (id, sizes, weights, kind, window): a few columns, 300 columns past the
#: staging cap, a total past 2^31, a source past 2^31 (int64 ids, the
#: 64-bit local draw), sources smaller than the window, one source, a
#: one-hot table
TABLES = [
    ("s3", (900, 600, 500), (5, 1, 2), "per_source", 64),
    ("s300", tuple(int(x) for x in _RNG.integers(1, 3000, 300)),
     tuple(int(x) for x in _RNG.integers(0, 50, 300)), "per_source", 32),
    ("total64", (5000, 6000), (2**40 + 1, 3**20), "per_source", 128),
    ("source64", (2**31 + 7, 1000, 2**32 + 5), (1, 2, 3), "per_source",
     8192),
    ("small", (100, 50), (1, 1), "per_sample", 4096),
    ("s1", (1000,), (7,), "per_source", 64),
    ("one-hot", (500, 500, 500), (0, 1, 0), "per_source", 16),
]
#: (epoch_samples, world, partition, drop_last): narrow, blocked with
#: wrap-padding cut, and wide ordinals
EPOCHS = [(1001, 3, "strided", False), (1001, 4, "blocked", True),
          (2**31 + 10, 2**20, "strided", False)]


@pytest.mark.parametrize("tid", [t[0] for t in TABLES])
def test_weighted_kernel_source_matches_plain_version(tid, host_kernels):
    _tid, sizes, weights, kind, window = next(t for t in TABLES
                                              if t[0] == tid)
    table = A.build_alias_table(weights, kind, sizes)
    launches = 0
    for T, world, partition, drop_last in EPOCHS:
        kernel = (ck.weighted_stream_wide if core.is_wide(T)
                  else ck.weighted_stream)
        ns, _ = core.shard_sizes(T, world, drop_last)
        for rank, seed, law in (
                (0, 0, {}), (world - 1, -3, dict(shuffle=False)),
                (world // 2, 2**40 + 9, dict(rounds=70, retry=3))):
            kw = dict(epoch_samples=T, rank=rank, world=world,
                      num_samples=ns, partition=partition, window=window,
                      **law)
            got = kernel(table, sizes, seed, 4, device="cpu", **kw)
            want = ck.weighted_stream_ref(table, sizes, seed, 4,
                                          device="cpu", **kw)
            assert got.dtype == want.dtype
            assert torch.equal(got, want), (T, world, rank, law)
            launches += 1
        chain, remaining, ns2 = core.elastic_chain(
            T, [(world * 2, ns // 3), (world + 1, 1)], world, drop_last)
        kw = dict(epoch_samples=T, rank=world - 1, world=world,
                  num_samples=ns2, partition=partition, chain=chain,
                  window=window)
        assert torch.equal(kernel(table, sizes, 1, 2, device="cpu", **kw),
                           ck.weighted_stream_ref(table, sizes, 1, 2,
                                                  device="cpu", **kw))
        launches += 1
    pos = torch.from_numpy(_RNG.integers(-2**63, 2**63 - 1, 500,
                                         dtype=np.int64))
    pos[:4] = torch.tensor([0, 1, -1, 2**32])
    got = ck.weighted_stream_wide(table, sizes, 7, 1, positions=pos,
                                  window=window, retry=2)
    assert torch.equal(got, A.weighted_stream_at_generic(
        pos, table, sizes, 7, 1, window=window, retry=2))
    launches += 1
    assert sum(ck.launches.values()) == launches


def test_weighted_kernel_narrow_and_wide_agree(host_kernels):
    table = A.build_alias_table((5, 1, 2), "per_source", (900, 600, 500))
    ns, _ = core.shard_sizes(1001, 3, False)
    narrow = ck.weighted_stream(table, (900, 600, 500), 7, 1,
                                epoch_samples=1001, rank=2, world=3,
                                num_samples=ns, window=64, device="cpu")
    pos = core.rank_positions(1001, 2, 3, ns, "strided", False)
    assert torch.equal(narrow, ck.weighted_stream_wide(
        table, (900, 600, 500), 7, 1, positions=pos, window=64))
    assert ck.launches["weighted_stream"] == 1
    assert ck.launches["weighted_stream_wide"] == 1


@pytest.mark.parametrize("n,window,world,partition,layers", [
    (100_000, 512, 8, "strided", [(4, 3000), (16, 100)]),
    (100_000, 512, 8, "blocked", [(4, 3000), (16, 100), (3, 5)]),
    (2**31 + 5000, 8192, 2**16, "strided", [(2**15, 3000)]),
    (2**31 + 5000, 8192, 2**16, "blocked", [(2**15, 3000), (7, 11)]),
])
def test_positions_kernel_chain_matches_plain_version(
        n, window, world, partition, layers, host_kernels):
    """``index_positions(_wide)`` composes its chain through
    ``csrc/chain.cuh``, the header the weighted kernel shares."""
    chain, _remaining, ns = core.elastic_chain(n, layers, world)
    kernel = (ck.index_positions_wide if core.is_wide(n)
              else ck.index_positions)
    for rank in (0, world - 1):
        kw = dict(rank=rank, world=world, num_samples=ns, chain=chain,
                  partition=partition)
        got = kernel(n, window, 5, 2, device="cpu", **kw)
        assert torch.equal(got, ck.index_positions_ref(
            n, window, 5, 2, device="cpu", **kw))
    assert sum(ck.launches.values()) == 2
