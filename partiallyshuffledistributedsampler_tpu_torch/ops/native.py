"""ctypes loader for the native C++ host path (``csrc/host/psds_core.cpp``).

``backend='native'`` evaluates the law on the host in C++: the fast host
route where no card serves, bit-identical to the plain law.  The source is
this package's own copy; :func:`build` compiles it with ``g++`` at first
use into the package's ``csrc/build/``, named by a hash of the source and
the flags, so an edited source builds anew and a stale library is never
loaded.  A build that fails raises ``RuntimeError``: a caller who asked for
'native' never gets another route.  The five entry points return numpy
arrays on the host.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Optional

import numpy as np

from . import core

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
_SOURCE = os.path.join(_CSRC, "host", "psds_core.cpp")
_BUILD_DIR = os.path.join(_CSRC, "build")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
#: the C ABI takes at most this many swap-or-not rounds
MAX_ROUNDS = 64

_lib: Optional[ctypes.CDLL] = None
_lib_path: Optional[str] = None


def library_path() -> str:
    """Where the build of the current source lives: named by a hash of the
    source and the flags."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(_SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(_BUILD_DIR,
                        f"libpsds_core-{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the source unless its build exists; return the .so path.
    The library is written under a temporary name and renamed, so a
    concurrent build never loads a half-written file."""
    so = library_path()
    if os.path.exists(so):
        return so
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("g++ not found: the native host kernel cannot "
                           "be built")
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, _SOURCE],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"native build failed (exit {res.returncode}):\n"
            f"{res.stderr[-2000:]}")
    os.replace(tmp, so)
    return so


def _load() -> ctypes.CDLL:
    global _lib, _lib_path
    so = build()
    if _lib is not None and _lib_path == so:
        return _lib
    try:
        lib = ctypes.CDLL(so)
    except OSError as exc:
        raise RuntimeError(f"native library {so} does not load: {exc}") \
            from None
    u64, u32, i32, ptr = (ctypes.c_uint64, ctypes.c_uint32, ctypes.c_int,
                          ctypes.c_void_p)
    lib.psds_epoch_indices.restype = i32
    lib.psds_epoch_indices.argtypes = [
        u64, u32, u32, u32, u32, u64, u64, i32, i32, i32, u32, u64, i32, ptr]
    lib.psds_expand_shards.restype = i32
    lib.psds_expand_shards.argtypes = [
        ptr, u64, ptr, ptr, u64, u32, u32, u32, i32, u32, u32, i32, ptr]
    lib.psds_mixture_indices.restype = i32
    lib.psds_mixture_indices.argtypes = [
        u32, ptr, ptr, ptr, ptr, ptr, u32, i32, u32, u32, u32, u64, u64,
        i32, i32, i32, u32, u64, i32, ptr]
    lib.psds_mixture_stream_at.restype = i32
    lib.psds_mixture_stream_at.argtypes = [
        u32, ptr, ptr, ptr, ptr, ptr, u32, i32, u32, u32, u32, i32, i32,
        u32, u64, ptr, i32, ptr]
    _lib, _lib_path = lib, so
    return lib


def available() -> bool:
    """Whether the native library loads (building it if needed): the
    'auto' rule's question, never a route of its own."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def _check_rounds(rounds: int) -> None:
    if rounds > MAX_ROUNDS:
        raise ValueError(f"native path supports rounds <= {MAX_ROUNDS}")


def _check_identity(rank: int, world: int, partition: str) -> None:
    if not 0 <= rank < world:
        raise ValueError(f"rank must be in [0, {world}), got {rank}")
    if partition not in ("strided", "blocked"):
        raise ValueError(
            f"partition must be 'strided' or 'blocked', got {partition!r}")


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


def epoch_indices_native(
    n: int,
    window: int,
    seed: int,
    epoch: int,
    rank: int,
    world: int,
    *,
    shuffle: bool = True,
    drop_last: bool = False,
    order_windows: bool = True,
    partition: str = "strided",
    rounds: int = core.DEFAULT_ROUNDS,
) -> np.ndarray:
    """One rank's epoch indices (SPEC.md §3/§4) through the C++ kernel:
    int32 for n < 2^31, else int64."""
    _check_identity(rank, world, partition)
    _check_rounds(rounds)
    lib = _load()
    num_samples, _ = core.shard_sizes(n, world, drop_last)
    out = np.empty(num_samples, dtype=np.int32 if n <= core.INT32_MAX
                   else np.int64)
    lo, hi = core.fold_seed(int(seed))
    rc = lib.psds_epoch_indices(
        n, window, lo, hi, int(epoch) & 0xFFFFFFFF, rank, world,
        int(bool(shuffle)), int(bool(order_windows)),
        int(partition == "strided"), rounds, num_samples, out.itemsize,
        _ptr(out))
    if rc != 0:
        raise ValueError(f"psds_epoch_indices failed with code {rc}")
    return out


def expand_shard_indices_native(
    shard_ids,
    shard_sizes,
    *,
    seed: int = 0,
    epoch: int = 0,
    within_shard_shuffle=True,
    rounds: int = core.DEFAULT_ROUNDS,
) -> np.ndarray:
    """The shard ids expanded to global sample indices (SPEC.md §7, int64)
    through the C++ kernel."""
    _check_rounds(rounds)
    lib = _load()
    sizes = np.ascontiguousarray(shard_sizes, dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    sids = np.ascontiguousarray(list(shard_ids), dtype=np.int64)
    if sids.size and (sids.min() < 0 or sids.max() >= len(sizes)):
        raise ValueError(
            f"shard ids must be in [0, {len(sizes)}); got range "
            f"[{sids.min()}, {sids.max()}]")
    total = int(sizes[sids].sum()) if sids.size else 0
    out = np.empty(total, dtype=np.int64)
    if total == 0:
        return out
    lo, hi = core.fold_seed(int(seed))
    full = within_shard_shuffle is True
    w_int = 0 if full else int(within_shard_shuffle)
    if w_int < 0:
        raise ValueError(
            f"within_shard_shuffle must be bool or >= 0, got {w_int}")
    # a window covering the largest shard is the whole shard; the cap
    # keeps the uint32 C ABI exact for any int
    w_int = min(w_int, 0x7FFFFFFF)
    rc = lib.psds_expand_shards(
        _ptr(sids), len(sids), _ptr(sizes), _ptr(offsets), len(sizes), lo,
        hi, int(epoch) & 0xFFFFFFFF, int(full), w_int, rounds, out.itemsize,
        _ptr(out))
    if rc != 0:
        raise ValueError(f"psds_expand_shards failed with code {rc}")
    return out


def _spec_tables(spec) -> tuple:
    """The spec's static tables as contiguous arrays of the C ABI's types
    (kept alive by the caller while the kernel reads them)."""
    return (np.ascontiguousarray(spec.sources, dtype=np.uint64),
            np.ascontiguousarray(spec.windows, dtype=np.uint32),
            np.ascontiguousarray(spec.pattern, dtype=np.int32),
            np.ascontiguousarray(spec.prefix, dtype=np.int64),
            np.ascontiguousarray(spec.quotas, dtype=np.uint64))


def _id_dtype(spec):
    return np.int32 if spec.total_sources_len <= core.INT32_MAX else np.int64


def mixture_epoch_indices_native(
    spec,
    seed: int,
    epoch: int,
    rank: int,
    world: int,
    *,
    epoch_samples=None,
    shuffle: bool = True,
    drop_last: bool = False,
    order_windows: bool = True,
    partition: str = "strided",
    rounds: int = core.DEFAULT_ROUNDS,
) -> np.ndarray:
    """One rank's mixture-epoch global ids (SPEC.md §8, both pattern
    versions) through the C++ kernel."""
    from .mixture import mixture_epoch_sizes

    _check_identity(rank, world, partition)
    _check_rounds(rounds)
    lib = _load()
    _t, num_samples, _total = mixture_epoch_sizes(spec, epoch_samples, world,
                                                  drop_last)
    out = np.empty(num_samples, dtype=_id_dtype(spec))
    lo, hi = core.fold_seed(int(seed))
    tabs = _spec_tables(spec)
    rc = lib.psds_mixture_indices(
        spec.num_sources, *(_ptr(t) for t in tabs), spec.block,
        int(spec.rotated(shuffle)), lo, hi, int(epoch) & 0xFFFFFFFF, rank,
        world, int(bool(shuffle)), int(bool(order_windows)),
        int(partition == "strided"), rounds, num_samples, out.itemsize,
        _ptr(out))
    if rc != 0:
        raise ValueError(f"psds_mixture_indices failed with code {rc}")
    return out


def mixture_stream_at_native(
    positions,
    spec,
    seed: int,
    epoch: int,
    *,
    shuffle: bool = True,
    order_windows: bool = True,
    rounds: int = core.DEFAULT_ROUNDS,
) -> np.ndarray:
    """Random access into the §8 stream through the C++ kernel, for
    non-negative positions; the output keeps the positions' shape."""
    _check_rounds(rounds)
    lib = _load()
    pos = np.ascontiguousarray(positions, dtype=np.int64)
    if pos.size and pos.min() < 0:
        raise ValueError("mixture positions must be >= 0")
    out = np.empty(pos.size, dtype=_id_dtype(spec))
    if pos.size == 0:
        return out.reshape(pos.shape)
    lo, hi = core.fold_seed(int(seed))
    tabs = _spec_tables(spec)
    rc = lib.psds_mixture_stream_at(
        spec.num_sources, *(_ptr(t) for t in tabs), spec.block,
        int(spec.rotated(shuffle)), lo, hi, int(epoch) & 0xFFFFFFFF,
        int(bool(shuffle)), int(bool(order_windows)), rounds, pos.size,
        _ptr(pos), out.itemsize, _ptr(out))
    if rc != 0:
        raise ValueError(f"psds_mixture_stream_at failed with code {rc}")
    return out.reshape(pos.shape)


def mixture_elastic_indices_native(
    spec,
    seed: int,
    epoch: int,
    rank: int,
    world: int,
    layers,
    *,
    epoch_samples=None,
    shuffle: bool = True,
    drop_last: bool = False,
    order_windows: bool = True,
    partition: str = "strided",
    rounds: int = core.DEFAULT_ROUNDS,
) -> np.ndarray:
    """The remainder-epoch mixture ids (SPEC.md §6 over §8): the positions
    of the rank's remainder share composed with torch ops on the host
    (uint64 position law), evaluated by the C++ stream-at kernel."""
    from .mixture import elastic_positions

    T = (spec.total_sources_len if epoch_samples is None
         else int(epoch_samples))
    chain, remaining, num_samples = core.elastic_chain(
        T, layers, int(world), bool(drop_last))
    if remaining == 0 or num_samples == 0:
        return np.empty(0, dtype=_id_dtype(spec))
    pos = elastic_positions(chain, remaining, int(rank), int(world),
                            num_samples, partition, True)
    return mixture_stream_at_native(
        pos.numpy(), spec, seed, epoch, shuffle=shuffle,
        order_windows=order_windows, rounds=rounds)
