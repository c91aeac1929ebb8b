"""Wrappers of the hand-written CUDA kernels in ``csrc/``.

Twelve kernels, each with a wrapper, a plain PyTorch version and a launch
counter:

====================  ===================================  ==========================
wrapper               plain version                        replaces
====================  ===================================  ==========================
index_general         ``index_general_ref``                ``ops/pallas_kernel.py``
                      (= ``core.epoch_indices_generic``)   ``_index_kernel``
index_amortized       ``epoch_indices_amortized_ref``      ``ops/pallas_kernel.py``
                      (``index_amortized_ref`` on          ``_amortized_kernel`` and
                      ``window_order_ids_ref``)            ``ops/xla.py``
                                                           ``_window_order_ids``
index_general_wide    ``index_general_wide_ref``           ``ops/core.py``
                      (= ``core.epoch_indices_generic``)   ``epoch_indices_generic``
                                                           (uint64 positions)
index_amortized_wide  ``epoch_indices_amortized_ref``      ``ops/xla.py``
                      (int64 lanes)                        ``_epoch_indices_amortized``
                                                           and ``_window_order_ids``
index_positions       ``index_positions_ref`` (the         ``ops/xla.py``
index_positions_wide  remainder chain or given positions,  ``elastic_indices_jax``,
                      then ``core.stream_indices_at_``     ``stream_indices_at_jax``
                      ``generic``)
mixture_source_keys   ``mixture_source_keys_ref``          ``ops/mixture.py``
                                                           ``_fused_mixture_eval``
                                                           (its [S] key vectors,
                                                           past the fold)
mixture_fused         ``mixture_fused_ref`` (the fused     ``ops/mixture.py``
                      evaluator of ``ops/mixture.py``)     ``_fused_mixture_eval``
shard_row_keys        ``shard_row_keys_ref``               ``sampler/shard_mode.py``
                      (``ops/shard.py``)                   ``_shard_epoch_keys`` and
                                                           the per-row key columns
shard_expand          ``shard_expand_ref``                 ``sampler/shard_mode.py``
                      (``ops/shard.py``)                   ``_class_expand_jit``,
                                                           ``_bucket_expand_jit``,
                                                           ``_bucket_scatter_jit``
weighted_stream       ``weighted_stream_ref`` (the rank's  ``sampling/alias.py``
weighted_stream_wide  ordinals, the remainder chain or     ``weighted_stream_at_``
                      given ordinals, then                 ``generic`` (under
                      ``sampling.alias.weighted_``         ``weighted_epoch_``
                      ``stream_at_generic``)               ``indices_jax``)
====================  ===================================  ==========================

(paths of the JAX package ``partiallyshuffledistributedsampler_tpu``).  The
three ``_wide`` index kernels serve index spaces n >= 2^31 with int64 output;
the others take n < 2^31 and write int32.  Each wrapper refuses the other
width, so a wide config is never narrowed.  ``mixture_fused`` takes uint32
or uint64 positions and writes int32 or int64 ids, by the mixture's sizes;
while a spec's keys and source table take at most ``FOLD_WORDS_CAP`` words
(``mixture_folds``) a regen lets it derive the keys itself, one launch;
past that ``mixture_source_keys`` writes them first.

Every kernel takes 0 to ``MAX_ROUNDS`` (4,096) swap-or-not rounds; a
wrapper raises ``ValueError`` above that.

The key of a launch is ``seed`` and ``epoch`` as scalars, or ``triple``:
an int32[3] tensor on the launch device holding the uint32 bits of
``(seed_lo, seed_hi, epoch)`` (``core.seed_triple``), which the kernel
reads from device memory — the output of the seed agreement in
``parallel/``, used without reading it back to the host.

A wrapper runs the plain version only for a CPU device, which is what the
CPU tests use; for a CUDA device it launches its kernel and raises on
anything the kernel does not take — there is no fallback.  ``launches``
counts kernel launches per wrapper, and nothing else.

The two ``weighted_stream`` kernels run the alias law of weighted,
prioritized and dedup sampling: the narrow one on uint32 ordinals (an
epoch below 2^31 draws), the wide one on uint64 ordinals and on given
ordinal buffers; both write int32 ids, or int64 when the sources total
2^31 or more.

The kernels are built with ``nvcc`` at first use into ``csrc/build/`` of
this package, one shared library per source (``index_kernels.cu``,
``mixture_kernels.cu``, ``shard_kernels.cu``, ``sampling_kernels.cu``), all
compiled at once and each named by a hash of every file its build may read
(the source and the headers ``law.cuh`` and ``chain.cuh``), so an edited
file rebuilds.  They are bound through ctypes over a plain C ABI.  Nothing is
built or imported from CUDA when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import numpy as np
import torch

from . import core, fastdiv, mixture, shard

_CSRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc"
)
#: one shared library per source; every build may also read ``_HEADERS``
_SOURCES = {"index": os.path.join(_CSRC, "index_kernels.cu"),
            "mixture": os.path.join(_CSRC, "mixture_kernels.cu"),
            "shard": os.path.join(_CSRC, "shard_kernels.cu"),
            "sampling": os.path.join(_CSRC, "sampling_kernels.cu")}
_HEADERS = (os.path.join(_CSRC, "law.cuh"), os.path.join(_CSRC, "chain.cuh"))
_BUILD_DIR = os.path.join(_CSRC, "build")
#: nvcc flags: Hopper's sm_90a, optimised, a shared library with a C ABI;
#: -Xptxas -v records registers and spills in ``build_log``
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: the most rounds a kernel takes (``csrc/law.cuh`` MAX_ROUNDS): the index
#: kernels' three schedules of 4,096 words in one block's shared memory
MAX_ROUNDS = 4096
#: words (keys + source table) that ``mixture_fused`` stages in shared
#: memory at most (``csrc/mixture_kernels.cu`` STAGE_WORDS_CAP): it can
#: derive its keys itself only then
STAGE_WORDS_CAP = 12288
#: staged words at most for which a regen folds the key derivation into
#: ``mixture_fused``: on the H100 the fold gained at 245 and 488 words and
#: lost at 974 (``chip_smoke.py``; PERF.md §6)
FOLD_WORDS_CAP = 576

#: kernel launches per wrapper (reset with ``reset_launches``)
launches = {"index_general": 0, "index_amortized": 0,
            "index_general_wide": 0, "index_amortized_wide": 0,
            "index_positions": 0, "index_positions_wide": 0,
            "mixture_source_keys": 0, "mixture_fused": 0,
            "shard_row_keys": 0, "shard_expand": 0,
            "weighted_stream": 0, "weighted_stream_wide": 0}

_libs: dict = {}
#: the compiler's output of the builds this process made ("" if prebuilt)
build_log = ""


class CudaUnavailableError(RuntimeError):
    """The CUDA path was asked for on a machine with no usable GPU."""


def require_cuda() -> None:
    """Raise ``CudaUnavailableError`` unless a CUDA GPU is usable — the
    CUDA path never quietly runs on the CPU instead."""
    if not torch.cuda.is_available():
        raise CudaUnavailableError(
            "the CUDA index path needs a usable CUDA GPU and "
            "torch.cuda.is_available() is False; ask for the host path "
            "explicitly (device='cpu' / backend='cpu')"
        )


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found (checked CUDA_HOME, CUDA_PATH, PATH and "
            "/usr/local/cuda/bin): the CUDA index kernels cannot be built"
        )
    return found


def library_path(name: str = "index") -> str:
    """Where the build of library ``name`` ('index', 'mixture', 'shard' or
    'sampling') of the current sources lives: named by a hash of every file
    its build may read and of the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in (_SOURCES[name], *_HEADERS):
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(
        _BUILD_DIR, f"libpsds_{name}_kernels-{digest.hexdigest()[:16]}.so"
    )


def build() -> dict:
    """Compile every library whose sources have no build yet, one ``nvcc``
    per source, all started together; return ``{name: .so path}``.  Each
    library is written under a temporary name and renamed, so concurrent
    builds never load a half-written file."""
    global build_log
    paths = {name: library_path(name) for name in _SOURCES}
    todo = {name: so for name, so in paths.items() if not os.path.exists(so)}
    if not todo:
        return paths
    os.makedirs(_BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {
        name: (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", f"{so}.{os.getpid()}.tmp",
             _SOURCES[name]],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), so)
        for name, so in todo.items()
    }
    logs, errors = [], []
    for name, (proc, so) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name} (exit {proc.returncode}):\n{err[-4000:]}")
            continue
        os.replace(f"{so}.{os.getpid()}.tmp", so)
        logs.append(out + err)
    if errors:
        raise RuntimeError("nvcc failed: " + "\n".join(errors))
    build_log = "".join(logs)
    return paths


def _load(name: str) -> ctypes.CDLL:
    if name not in _libs:
        lib = ctypes.CDLL(build()[name])
        u64, u32 = ctypes.c_uint64, ctypes.c_uint32
        i32, ptr = ctypes.c_int, ctypes.c_void_p
        keys = [u32, u32, u32, ptr]  # seed_lo, seed_hi, epoch, seeds
        if name == "index":
            fns = (lib.psds_index_general, lib.psds_index_general_wide,
                   lib.psds_index_amortized, lib.psds_index_amortized_wide,
                   lib.psds_index_positions, lib.psds_index_positions_wide)
            general = [ptr, u64, u32, u32, u64, u32, *keys, i32, i32, i32,
                       i32, ptr]
            amortized = [ptr, u64, u32, u32, u64, u32, *keys, i32, i32, ptr]
            positions = [ptr, ptr, u64, u64, u32, u32, u32, ptr, u32, u64,
                         u64, u32, *keys, i32, i32, i32, i32, ptr]
            lib.psds_index_general.argtypes = general
            lib.psds_index_general_wide.argtypes = general
            lib.psds_index_amortized.argtypes = amortized
            lib.psds_index_amortized_wide.argtypes = amortized
            lib.psds_index_positions.argtypes = positions
            lib.psds_index_positions_wide.argtypes = positions
        elif name == "sampling":
            fns = (lib.psds_weighted_stream, lib.psds_weighted_stream_wide)
            for fn in fns:
                fn.argtypes = [ptr, ptr, u64, ptr, u32, i32, u64, u64, u32,
                               u32, u32, i32, ptr, u32, u64, u64, u32, u32,
                               u32, u32, u64, u32, u32, u32, u32, u32, i32,
                               i32, i32, i32, i32, ptr]
        elif name == "shard":
            fns = (lib.psds_shard_row_keys, lib.psds_shard_expand)
            lib.psds_shard_row_keys.argtypes = [ptr, ptr, ptr, u64, ptr, u32,
                                                i32, i32, *keys, ptr]
            lib.psds_shard_expand.argtypes = [ptr, ptr, ptr, ptr, ptr, u64,
                                              u64, u32, u64, u32, u32, u32,
                                              u32, u32, u32, i32, i32, i32,
                                              ptr]
        else:
            fns = (lib.psds_mixture_source_keys, lib.psds_mixture_fused)
            lib.psds_mixture_source_keys.argtypes = [ptr, ptr, i32, i32,
                                                     *keys, ptr]
            lib.psds_mixture_fused.argtypes = [
                ptr, ptr, u64, u64, u64, i32, u32, i32, ptr, ptr, ptr, ptr,
                *keys, i32, i32, i32, i32, i32, i32, ptr,
            ]
        for fn in fns:
            fn.restype = i32
        _libs[name] = lib
    return _libs[name]


def _check(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def device_kind(device) -> str:
    """'cpu' (plain version) or 'cuda' (kernel); anything else raises."""
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"the index kernels run on 'cuda' (or their plain version on "
            f"'cpu'), got device {device}"
        )
    if device.type == "cuda":
        require_cuda()
    return device.type


def _plain_keys(seed, epoch, triple):
    """The ``(seed, epoch)`` arguments of the plain law from a launch's key
    source: the scalars as given, or 0-d views on ``triple``.  Raises
    unless exactly one of the two sources is given and ``triple`` is a
    contiguous int32[3] tensor."""
    if triple is None:
        if seed is None or epoch is None:
            raise ValueError("pass seed and epoch, or triple")
        return seed, epoch
    if seed is not None or epoch is not None:
        raise ValueError("pass seed and epoch, or triple, not both")
    if not (isinstance(triple, torch.Tensor) and triple.dtype == torch.int32
            and tuple(triple.shape) == (3,) and triple.is_contiguous()):
        raise ValueError(
            "triple must be a contiguous int32[3] tensor of the uint32 bits "
            "of (seed_lo, seed_hi, epoch)"
        )
    return core.triple_seed_epoch(triple)


def _launch_keys(seed, epoch, triple, device: torch.device) -> tuple:
    """A launch's ``(seed_lo, seed_hi, epoch, seeds)`` arguments: the
    scalars and a null pointer, or zeros and the address of ``triple``."""
    if triple is None:
        return (*core.seed_triple(seed, epoch), None)
    if triple.device != device:
        raise ValueError(
            f"triple lies on {triple.device}, the launch on {device}"
        )
    return 0, 0, 0, triple.data_ptr()


def _check_width(n: int, wide: bool) -> None:
    """The wide kernels take n >= 2^31, the others n < 2^31."""
    if core.is_wide(n) != wide:
        raise ValueError(
            f"n={n} needs the {'wide' if core.is_wide(n) else 'narrow'} "
            f"kernel (int64 output for n >= 2^31, int32 below)"
        )


def _check_rounds(rounds: int) -> None:
    """The kernels take 0 to MAX_ROUNDS rounds; more is refused."""
    if not 0 <= rounds <= MAX_ROUNDS:
        raise ValueError(
            f"rounds must be in [0, {MAX_ROUNDS}] on the card, got {rounds}")


def _check_kernel_args(n: int, window: int, world: int, rounds: int,
                       wide: bool) -> None:
    """What the kernels' arguments can carry, and the width of the index
    space each kernel takes."""
    _check_width(n, wide)
    for name, v in (("window", window), ("world", world)):
        if not 1 <= v <= core.INT32_MAX:
            raise ValueError(f"{name} must be in [1, 2^31), got {v}")
    core.check_index_space(n, window)
    _check_rounds(rounds)


# ---------------------------------------------------------------- plain
def window_order_ids_ref(n: int, window: int, seed, epoch, *,
                         order_windows: bool = True,
                         rounds: int = core.DEFAULT_ROUNDS,
                         device=None) -> torch.Tensor:
    """Compact per-window source ids ``ku`` (int64[n // window]): the outer
    bijection evaluated once per window slot."""
    nw = n // window
    ek = core.derive_epoch_key(seed, epoch)
    j = torch.arange(nw, dtype=torch.int64, device=device)
    if order_windows and nw > 1:
        return core.swap_or_not(j, nw, core.outer_key(ek), rounds)
    return j


#: the general law per lane (int32, n < 2^31)
index_general_ref = core.epoch_indices_generic
#: the general law per lane with uint64 positions (int64, n >= 2^31): the
#: law's own wide form, ``core.rank_positions`` without the 2^32 wrap
index_general_wide_ref = core.epoch_indices_generic


def index_amortized_ref(ku: torch.Tensor, n: int, window: int, seed, epoch,
                        rank: int, world: int, num_samples: int, *,
                        order_windows: bool = True,
                        rounds: int = core.DEFAULT_ROUNDS) -> torch.Tensor:
    """The amortized evaluation on ``ku``'s device: body lanes
    ``t < nw*m`` take ``ku[t // m]*W + inner bijection of
    rank + world*(t % m)``; the remaining lanes take the general law.
    Equal to the general law by algebra (strided partition,
    ``window % world == 0``).  int32 (int64 when n >= 2^31)."""
    m = window // world
    body = (n // window) * m
    wide = core.is_wide(n)
    ek = core.derive_epoch_key(seed, epoch)
    t = torch.arange(body, dtype=torch.int64, device=ku.device)
    kex = ku.to(torch.int64)[t // m]
    r0 = rank + world * (t % m)
    rho = core.swap_or_not(r0, window, core.inner_key(ek, kex), rounds,
                           pair_key=core.inner_pair_key(ek))
    idx = kex * window + rho
    if num_samples > body:
        # tail-window + wrap-padded lanes: the general law on a short slice
        tpos = torch.arange(body, num_samples, dtype=torch.int64,
                            device=ku.device)
        p = core.wrap_pos(rank + core.wrap_pos(world * tpos, wide), wide) % n
        tail = core.windowed_perm(p, n, window, ek,
                                  order_windows=order_windows, rounds=rounds)
        idx = torch.cat([idx, tail])
    return idx[:num_samples].to(core.out_dtype(n))


def epoch_indices_amortized_ref(n: int, window: int, seed, epoch, rank: int,
                                world: int, num_samples: int, *,
                                order_windows: bool = True,
                                rounds: int = core.DEFAULT_ROUNDS,
                                device=None) -> torch.Tensor:
    """The whole plain amortized evaluation on ``device``, what one launch
    of ``index_amortized(_wide)`` computes: the window-order ids
    (``window_order_ids_ref``), then one bijection per element
    (``index_amortized_ref``).  Same value as
    ``core.epoch_indices_generic``."""
    ku = window_order_ids_ref(n, window, seed, epoch,
                              order_windows=order_windows, rounds=rounds,
                              device=device)
    return index_amortized_ref(ku, n, window, seed, epoch, rank, world,
                               num_samples, order_windows=order_windows,
                               rounds=rounds)


# ---------------------------------------------------------------- kernels
def _general(wide: bool, n: int, window: int, seed, epoch, rank: int,
             world: int, *, shuffle: bool, drop_last: bool,
             order_windows: bool, partition: str, rounds: int, device,
             triple) -> torch.Tensor:
    name = "index_general_wide" if wide else "index_general"
    kwargs = dict(shuffle=shuffle, drop_last=drop_last,
                  order_windows=order_windows, partition=partition,
                  rounds=rounds)
    seed_p, epoch_p = _plain_keys(seed, epoch, triple)
    if device_kind(device) == "cpu":
        _check_width(n, wide)
        return core.epoch_indices_generic(n, window, seed_p, epoch_p, rank,
                                          world, device=device, **kwargs)
    _check_kernel_args(n, window, world, rounds, wide)
    if partition not in ("strided", "blocked"):
        raise ValueError(
            f"partition must be 'strided' or 'blocked', got {partition!r}"
        )
    if not 0 <= rank < world:
        raise ValueError(f"rank must be in [0, {world}), got {rank}")
    num_samples, _ = core.shard_sizes(n, world, drop_last)
    lib = _load("index")
    out = torch.empty(num_samples, dtype=core.out_dtype(n), device=device)
    lo, hi, ep, seeds = _launch_keys(seed, epoch, triple, out.device)
    stream = torch.cuda.current_stream(out.device).cuda_stream
    fn = lib.psds_index_general_wide if wide else lib.psds_index_general
    launches[name] += 1
    _check(name, fn(
        out.data_ptr(), n, window, world, num_samples, rank, lo, hi, ep,
        seeds, int(bool(shuffle)), int(bool(order_windows)),
        int(partition == "strided"), rounds, stream,
    ))
    return out


def index_general(n: int, window: int, seed, epoch, rank: int, world: int,
                  *, shuffle: bool = True, drop_last: bool = False,
                  order_windows: bool = True, partition: str = "strided",
                  rounds: int = core.DEFAULT_ROUNDS,
                  device="cuda", triple=None) -> torch.Tensor:
    """Rank's epoch indices by the general law: int32[num_samples], for
    n < 2^31."""
    return _general(False, n, window, seed, epoch, rank, world,
                    shuffle=shuffle, drop_last=drop_last,
                    order_windows=order_windows, partition=partition,
                    rounds=rounds, device=device, triple=triple)


def index_general_wide(n: int, window: int, seed, epoch, rank: int,
                       world: int, *, shuffle: bool = True,
                       drop_last: bool = False, order_windows: bool = True,
                       partition: str = "strided",
                       rounds: int = core.DEFAULT_ROUNDS,
                       device="cuda", triple=None) -> torch.Tensor:
    """Rank's epoch indices by the general law with uint64 positions:
    int64[num_samples], for n >= 2^31 (num_samples may pass 2^32)."""
    return _general(True, n, window, seed, epoch, rank, world,
                    shuffle=shuffle, drop_last=drop_last,
                    order_windows=order_windows, partition=partition,
                    rounds=rounds, device=device, triple=triple)


def _amortized(wide: bool, n: int, window: int, seed, epoch, rank: int,
               world: int, *, drop_last: bool, order_windows: bool,
               rounds: int, device, triple) -> torch.Tensor:
    name = "index_amortized_wide" if wide else "index_amortized"
    num_samples, _ = core.shard_sizes(n, world, drop_last)
    if not (window % world == 0 and n // window >= 1):
        raise ValueError(
            f"the amortized law needs window % world == 0 and n >= window "
            f"(n={n}, window={window}, world={world})"
        )
    seed_p, epoch_p = _plain_keys(seed, epoch, triple)
    if device_kind(device) == "cpu":
        _check_width(n, wide)
        return epoch_indices_amortized_ref(
            n, window, seed_p, epoch_p, rank, world, num_samples,
            order_windows=order_windows, rounds=rounds, device=device)
    _check_kernel_args(n, window, world, rounds, wide)
    if num_samples > core.INT32_MAX:
        raise ValueError(
            f"the amortized kernels take ceil(n / world) < 2^31, got "
            f"{num_samples} lanes: use the general kernel"
        )
    if not 0 <= rank < world:
        raise ValueError(f"rank must be in [0, {world}), got {rank}")
    lib = _load("index")
    out = torch.empty(num_samples, dtype=core.out_dtype(n), device=device)
    lo, hi, ep, seeds = _launch_keys(seed, epoch, triple, out.device)
    stream = torch.cuda.current_stream(out.device).cuda_stream
    fn = lib.psds_index_amortized_wide if wide else lib.psds_index_amortized
    launches[name] += 1
    _check(name, fn(
        out.data_ptr(), n, window, world, num_samples, rank, lo, hi, ep,
        seeds, int(bool(order_windows)), rounds, stream,
    ))
    return out


def index_amortized(n: int, window: int, seed, epoch, rank: int, world: int,
                    *, drop_last: bool = False, order_windows: bool = True,
                    rounds: int = core.DEFAULT_ROUNDS, device="cuda",
                    triple=None) -> torch.Tensor:
    """Rank's epoch indices by the amortized law, the window order and the
    elements in one launch: int32[num_samples], for n < 2^31.  Takes only
    strided, shuffled configs with ``window % world == 0`` and at least
    one full window."""
    return _amortized(False, n, window, seed, epoch, rank, world,
                      drop_last=drop_last, order_windows=order_windows,
                      rounds=rounds, device=device, triple=triple)


def index_amortized_wide(n: int, window: int, seed, epoch, rank: int,
                         world: int, *, drop_last: bool = False,
                         order_windows: bool = True,
                         rounds: int = core.DEFAULT_ROUNDS, device="cuda",
                         triple=None) -> torch.Tensor:
    """``index_amortized`` for n >= 2^31: int64[num_samples], with
    ceil(n / world) < 2^31."""
    return _amortized(True, n, window, seed, epoch, rank, world,
                      drop_last=drop_last, order_windows=order_windows,
                      rounds=rounds, device=device, triple=triple)


# -------------------------------------------------------------- positions
#: uint64 words of one reshard layer in the chain table
#: (``csrc/index_kernels.cu`` LAYER_WORDS): the add (consumed*world
#: strided, consumed blocked), num_samples, the gap ns - consumed, its magic
#: multiplier and packed shifts (s1 | s2 << 8), the modulus after the layer
#: (the next outer layer's remaining count, n after the outermost), its
#: magic multiplier and packed shifts
LAYER_WORDS = 8
#: cached device chain tables: (n, chain, partition, device) -> tensor
_chain_tables: dict = {}
_CHAIN_TABLES_CAP = 16


def _divisor(d: int, bits: int) -> list:
    """A divisor's table words: d, its magic multiplier, s1 | s2 << 8."""
    mult, s1, s2 = fastdiv.magic(d, bits)
    return [d, mult, s1 | (s2 << 8)]


def _as_chain(chain) -> tuple:
    return tuple(tuple(int(v) for v in layer) for layer in chain)


@functools.lru_cache(maxsize=64)
def chain_plan(n: int, chain: tuple, partition: str, wide: bool) -> tuple:
    """``(words, first)`` of a reshard chain (the outermost-first
    ``(world, num_samples, consumed)`` triples of ``core.elastic_chain``):
    the chain table as uint64 words, ``LAYER_WORDS`` a layer, innermost
    layer first, with every divisor's magic numbers for 32-bit (n < 2^31)
    or 64-bit positions; and the innermost remaining count R, the modulus
    of the lanes' first positions, as a divisor's words ``(R, mult,
    shift)``.  Raises ``ValueError`` on a chain the law cannot
    take, whichever route runs: an empty chain, a world below 1, a layer
    fully consumed (as ``core.remaining_stream_positions``), and for
    n < 2^31 a layer constant of 2^32 or more (the reference casts them to
    uint32)."""
    if partition not in ("strided", "blocked"):
        raise ValueError(
            f"partition must be 'strided' or 'blocked', got {partition!r}")
    if not chain:
        raise ValueError("the reshard chain is empty: it holds at least the "
                         "base epoch's layer")
    bits = 64 if wide else 32
    for i, (world, ns, consumed) in enumerate(chain):
        if world < 1:
            raise ValueError(
                f"world must be >= 1, got {world} in reshard layer {i}")
        if consumed >= ns:
            raise ValueError(
                f"epoch fully consumed (consumed={consumed} >= "
                f"num_samples={ns}); the remainder is empty")
        if consumed < 0:
            raise ValueError(
                f"consumed must be >= 0, got {consumed} in reshard layer {i}")
    words = []
    for i in range(len(chain) - 1, -1, -1):
        world, ns, consumed = chain[i]
        if i == 0:
            after = n
        else:
            w_prev, ns_prev, c_prev = chain[i - 1]
            after = (ns_prev - c_prev) * w_prev
        gap = ns - consumed
        if partition == "strided":
            add, used = consumed * world, {"consumed*world": consumed * world}
        else:
            add, used = consumed, {"num_samples": ns, "consumed": consumed}
        used["the remaining count after it"] = after
        for name, v in used.items():
            if not wide and v > core._M32:
                raise ValueError(
                    f"reshard layer {i}: {name} = {v} does not fit the "
                    f"uint32 positions of n < 2^31")
        words += [add, ns, *_divisor(gap, bits), *_divisor(after, bits)]
    world, ns, consumed = chain[-1]
    remaining = (ns - consumed) * world
    if not wide and remaining > core._M32:
        raise ValueError(
            f"the remaining count {remaining} does not fit the uint32 "
            f"positions of n < 2^31")
    return np.array(words, dtype=np.uint64), tuple(_divisor(remaining, bits))


def chain_table(n: int, chain, partition: str, device) -> torch.Tensor:
    """The chain table of ``chain_plan`` as an int64 tensor (the uint64
    bits) on ``device``, built once per ``(n, chain, partition, device)``
    and cached, so a regen of a known chain copies nothing to the card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    chain = _as_chain(chain)
    key = (int(n), chain, partition, str(device))
    table = _chain_tables.get(key)
    if table is None:
        words, _first = chain_plan(int(n), chain, partition,
                                   core.is_wide(n))
        table = torch.from_numpy(words.view(np.int64)).to(device)
        if len(_chain_tables) >= _CHAIN_TABLES_CAP:
            _chain_tables.pop(next(iter(_chain_tables)))
        _chain_tables[key] = table
    return table


def index_positions_ref(n: int, window: int, seed, epoch, *, positions=None,
                        rank=None, world=None, num_samples=None, chain=None,
                        partition: str = "strided", shuffle: bool = True,
                        order_windows: bool = True,
                        rounds: int = core.DEFAULT_ROUNDS,
                        device=None) -> torch.Tensor:
    """The plain version of ``index_positions(_wide)``: the given
    ``positions`` (``core.stream_indices_at_generic``), or the rank's
    remainder-epoch positions composed through ``chain``
    (``core.rank_positions``, ``core.compose_remainder_chain``, then the
    same), on ``device`` (the positions' device when they are given)."""
    law = dict(shuffle=shuffle, order_windows=order_windows, rounds=rounds)
    if positions is not None:
        return core.stream_indices_at_generic(positions, n, window, seed,
                                              epoch, **law)
    return core.elastic_indices_generic(
        n, window, seed, epoch, rank, world, num_samples, _as_chain(chain),
        partition=partition, device=device, **law)


def _check_positions_source(positions, rank, world, num_samples,
                            chain) -> None:
    """Lanes come from ``positions`` or from ``(rank, world, num_samples,
    chain)``: exactly one of the two, and each in range."""
    if positions is not None:
        if any(v is not None for v in (rank, world, num_samples, chain)):
            raise ValueError("pass positions, or rank, world, num_samples "
                             "and chain, not both")
        if not (isinstance(positions, torch.Tensor)
                and positions.dtype == torch.int64):
            raise ValueError("positions must be an int64 tensor")
        return
    if any(v is None for v in (rank, world, num_samples, chain)):
        raise ValueError("pass positions, or rank, world, num_samples and "
                         "chain")
    if not 1 <= world <= core.INT32_MAX:
        raise ValueError(f"world must be in [1, 2^31), got {world}")
    if not 0 <= rank < world:
        raise ValueError(f"rank must be in [0, {world}), got {rank}")
    if num_samples < 0:
        raise ValueError(f"num_samples must be >= 0, got {num_samples}")


def _positions(wide: bool, n: int, window: int, seed, epoch, *, positions,
               rank, world, num_samples, chain, partition: str,
               shuffle: bool, order_windows: bool, rounds: int, device,
               triple) -> torch.Tensor:
    name = "index_positions_wide" if wide else "index_positions"
    n, window = int(n), int(window)
    if positions is None:
        rank, world, num_samples = (None if v is None else int(v)
                                    for v in (rank, world, num_samples))
    _check_positions_source(positions, rank, world, num_samples, chain)
    seed_p, epoch_p = _plain_keys(seed, epoch, triple)
    _check_width(n, wide)
    core.check_index_space(n, window)
    if chain is not None:
        chain = _as_chain(chain)
        first = chain_plan(n, chain, partition, wide)[1]
    dev = positions.device if positions is not None else torch.device(device)
    law = dict(shuffle=shuffle, order_windows=order_windows, rounds=rounds)
    if device_kind(dev) == "cpu":
        return index_positions_ref(
            n, window, seed_p, epoch_p, positions=positions, rank=rank,
            world=world, num_samples=num_samples, chain=chain,
            partition=partition, device=dev, **law)
    _check_rounds(rounds)
    if positions is not None:
        p = positions.contiguous()
        out = torch.empty(p.shape, dtype=core.out_dtype(n), device=p.device)
        lanes, first = p.numel(), tuple(_divisor(n, 64 if wide else 32))
        layers, depth, rank, world = None, 0, 0, 1
    else:
        out = torch.empty(num_samples, dtype=core.out_dtype(n), device=dev)
        lanes, depth = num_samples, len(chain)
        layers = chain_table(n, chain, partition, out.device).data_ptr()
    if lanes == 0:
        return out
    lib = _load("index")
    lo, hi, ep, seeds = _launch_keys(seed, epoch, triple, out.device)
    stream = torch.cuda.current_stream(out.device).cuda_stream
    fn = lib.psds_index_positions_wide if wide else lib.psds_index_positions
    launches[name] += 1
    _check(name, fn(
        out.data_ptr(), None if positions is None else p.data_ptr(), lanes,
        n, window, world, rank, layers, depth, *first, lo, hi, ep, seeds,
        int(bool(shuffle)), int(bool(order_windows)),
        int(partition == "strided"), rounds, stream,
    ))
    return out


def index_positions(n: int, window: int, seed, epoch, *, positions=None,
                    rank=None, world=None, num_samples=None, chain=None,
                    partition: str = "strided", shuffle: bool = True,
                    order_windows: bool = True,
                    rounds: int = core.DEFAULT_ROUNDS, device="cuda",
                    triple=None) -> torch.Tensor:
    """The stream law on positions from another source than ``rank +
    world*t``, for n < 2^31, int32: the given int64 ``positions`` (any
    shape, on the launch device; their low 32 bits, mod n), or the rank's
    ``num_samples`` remainder-epoch positions, composed through the
    outermost-first reshard ``chain`` of ``core.elastic_chain`` in the
    kernel (SPEC.md §6), on ``device``."""
    return _positions(False, n, window, seed, epoch, positions=positions,
                      rank=rank, world=world, num_samples=num_samples,
                      chain=chain, partition=partition, shuffle=shuffle,
                      order_windows=order_windows, rounds=rounds,
                      device=device, triple=triple)


def index_positions_wide(n: int, window: int, seed, epoch, *,
                         positions=None, rank=None, world=None,
                         num_samples=None, chain=None,
                         partition: str = "strided", shuffle: bool = True,
                         order_windows: bool = True,
                         rounds: int = core.DEFAULT_ROUNDS, device="cuda",
                         triple=None) -> torch.Tensor:
    """``index_positions`` for n >= 2^31: uint64 position math (given
    positions taken as uint64 bits), int64 output."""
    return _positions(True, n, window, seed, epoch, positions=positions,
                      rank=rank, world=world, num_samples=num_samples,
                      chain=chain, partition=partition, shuffle=shuffle,
                      order_windows=order_windows, rounds=rounds,
                      device=device, triple=triple)


# ---------------------------------------------------------------- mixture
#: cached device tables of a mixture spec: (spec.key(), device) -> tensors
_mixture_tables: dict = {}
_MIXTURE_TABLES_CAP = 16


def _source_table(spec) -> np.ndarray:
    """uint32 [S, 8] rows of the mixture kernels: n, W, nw, tail, k,
    body = nw*W, base lo, base hi."""
    n = np.asarray(spec.sources, dtype=np.uint64)
    w = np.asarray(spec.windows, dtype=np.uint64)
    nw = n // w
    base = np.asarray(spec.bases, dtype=np.uint64)
    cols = [n, w, nw, n - nw * w, np.asarray(spec.quotas, dtype=np.uint64),
            nw * w, base & 0xFFFFFFFF, base >> np.uint64(32)]
    return np.stack(cols, axis=1).astype(np.uint32)


def mixture_tables(spec, device) -> tuple:
    """``(pattern, prefix, src)`` of ``spec`` as int32 tensors on
    ``device``, built once per ``(spec.key(), device)`` and cached: the
    pattern [B], the prefix counts [B*S] and the source table [S*8] (the
    uint32 bits of ``_source_table``)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (spec.key(), str(device))
    tabs = _mixture_tables.get(key)
    if tabs is None:
        host = (np.asarray(spec.pattern, dtype=np.int32),
                spec.prefix.astype(np.int32).reshape(-1),
                _source_table(spec).view(np.int32).reshape(-1))
        tabs = tuple(torch.from_numpy(np.array(a)).to(device) for a in host)
        if len(_mixture_tables) >= _MIXTURE_TABLES_CAP:
            _mixture_tables.pop(next(iter(_mixture_tables)))
        _mixture_tables[key] = tabs
    return tabs


def mixture_key_words(spec, rounds: int) -> int:
    """Length of the keys buffer: rk, the epoch, and per source its seed
    key and ``3 * rounds`` pairing constants."""
    return 2 + spec.num_sources * (1 + 3 * int(rounds))


def _staged_words(spec, rounds: int) -> int:
    """Words every block of ``mixture_fused`` stages: the keys buffer and
    the source table (8 words a source)."""
    return mixture_key_words(spec, rounds) + 8 * spec.num_sources


def mixture_folds(spec, rounds: int) -> bool:
    """Whether a regen of this spec lets ``mixture_fused`` derive the keys
    itself (one launch) rather than launch ``mixture_source_keys`` first:
    while its staged words are at most ``FOLD_WORDS_CAP``."""
    return _staged_words(spec, rounds) <= FOLD_WORDS_CAP


def mixture_source_keys_ref(spec, seed, epoch, *,
                            rounds: int = core.DEFAULT_ROUNDS,
                            device=None) -> torch.Tensor:
    """The keys buffer (int32 bits of uint32 words) by torch ops: ``[rk,
    epoch]``, then per source ``[seed_key, K_outer[rounds],
    K_inner[rounds], K_tail[rounds]]`` with ``K_r = mix32(pair ^
    r*GOLDEN) % m`` (0 where ``m <= 1``) from the pass-free per-source
    epoch key."""
    tab = mixture._source_tables(spec, device)
    lo_s, hi_s, ek0 = mixture._source_keys(spec, seed, epoch, device)
    sk = core.mix32(core.mix32(lo_s ^ core._GOLDEN)
                    ^ core.mix32(hi_s ^ core._C_SEED_HI))
    rg = (torch.arange(rounds, dtype=torch.int64, device=device)
          * core._GOLDEN) & core._M32

    def schedule(pair, m):
        k = core.mix32(pair[:, None] ^ rg[None, :]) % m.clamp(min=1)[:, None]
        return torch.where(m[:, None] > 1, k, torch.zeros_like(k))

    rows = torch.cat([
        sk[:, None], schedule(core.outer_key(ek0), tab["nw"]),
        schedule(core.inner_pair_key(ek0), tab["w"]),
        schedule(core.tail_key(ek0), tab["tail"]),
    ], dim=1).reshape(-1)
    head = torch.stack([
        torch.as_tensor(v, dtype=torch.int64, device=device)
        for v in (mixture.rotation_key(seed, epoch),
                  core.as_u32_scalar(epoch))
    ])
    return core.u32_bits(torch.cat([head, rows]))


def mixture_source_keys(spec, seed, epoch, *,
                        rounds: int = core.DEFAULT_ROUNDS, device="cuda",
                        triple=None) -> torch.Tensor:
    """The keys buffer of one regen (``mixture_source_keys_ref``):
    int32[2 + S*(1 + 3*rounds)] on ``device``, from the scalars or from
    the seed triple in device memory."""
    seed_p, epoch_p = _plain_keys(seed, epoch, triple)
    if device_kind(device) == "cpu":
        return mixture_source_keys_ref(spec, seed_p, epoch_p, rounds=rounds,
                                       device=device)
    _check_rounds(rounds)
    lib = _load("mixture")
    _pattern, _prefix, src = mixture_tables(spec, device)
    keys = torch.empty(mixture_key_words(spec, rounds), dtype=torch.int32,
                       device=src.device)
    lo, hi, ep, seeds = _launch_keys(seed, epoch, triple, keys.device)
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    launches["mixture_source_keys"] += 1
    _check("mixture_source_keys", lib.psds_mixture_source_keys(
        keys.data_ptr(), src.data_ptr(), spec.num_sources, rounds, lo, hi,
        ep, seeds, stream,
    ))
    return keys


def _check_lane_source(rank, world, num_samples, positions) -> None:
    """A ``mixture_fused`` call takes its lanes from ``positions`` or from
    ``(rank, world, num_samples)``: exactly one of the two."""
    if positions is not None:
        if rank is not None or world is not None or num_samples is not None:
            raise ValueError("pass positions, or rank, world and "
                             "num_samples, not both")
    elif rank is None or world is None or num_samples is None:
        raise ValueError("pass positions, or rank, world and num_samples")


def mixture_fused_ref(keys, spec, seed, epoch, *, rank=None, world=None,
                      num_samples=None, partition="strided", positions=None,
                      wide_pos: bool, shuffle: bool = True,
                      order_windows: bool = True,
                      rounds: int = core.DEFAULT_ROUNDS,
                      device=None) -> torch.Tensor:
    """The mixture stream at the lanes' positions on ``keys``' device (or
    ``device`` when ``keys`` is None, the folded keys): the fused per-lane
    evaluator of ``ops/mixture.py`` (the masked loop for an unshuffled
    stream, whose law is the identity per source)."""
    _check_lane_source(rank, world, num_samples, positions)
    dev = torch.device(device if keys is None else keys.device)
    if positions is None:
        p = mixture.rank_stream_positions(spec, rank, world, num_samples,
                                          partition, wide_pos, dev)
    else:
        p = torch.as_tensor(positions).to(dev, torch.int64)
    return mixture.mixture_stream_at_generic(
        p, spec, seed, epoch, shuffle=shuffle,
        order_windows=order_windows, rounds=rounds, big_positions=wide_pos,
        amortize=False,
    )


def mixture_fused(keys, spec, seed, epoch, *, rank=None, world=None,
                  num_samples=None, partition="strided", positions=None,
                  wide_pos: bool, shuffle: bool = True,
                  order_windows: bool = True,
                  rounds: int = core.DEFAULT_ROUNDS, device="cuda",
                  triple=None) -> torch.Tensor:
    """Mixture ids, one lane per position: the rank's own positions
    (``rank``, ``world``, ``num_samples``, ``partition``) or an int64
    ``positions`` tensor on the launch device.  ``keys`` is this regen's
    ``mixture_source_keys`` buffer, and its device the launch's; or None,
    and the kernel derives the keys itself from the scalars or ``triple``
    (specs whose keys it stages), on ``device``.  ``wide_pos`` selects
    uint64 position math.  int32 ids, or int64 when the sources total 2^31
    or more.  Takes only mixtures whose sources are all below 2^31."""
    seed_p, epoch_p = _plain_keys(seed, epoch, triple)
    dev = torch.device(device if keys is None else keys.device)
    if device_kind(dev) == "cpu":
        return mixture_fused_ref(
            keys, spec, seed_p, epoch_p, rank=rank, world=world,
            num_samples=num_samples, partition=partition,
            positions=positions, wide_pos=wide_pos, shuffle=shuffle,
            order_windows=order_windows, rounds=rounds, device=dev)
    if not spec.fused_applies():
        raise ValueError(
            "the mixture kernel takes sources below 2^31; larger sources "
            "take the masked evaluator (fused=False)"
        )
    _check_rounds(rounds)
    if spec.block > core.INT32_MAX:
        raise ValueError(f"block must be < 2^31, got {spec.block}")
    if keys is None:
        if _staged_words(spec, rounds) > STAGE_WORDS_CAP:
            raise ValueError(
                f"{spec.num_sources} sources at {rounds} rounds take more "
                f"than {STAGE_WORDS_CAP} staged words: pass the "
                "mixture_source_keys buffer"
            )
    elif (keys.dtype != torch.int32 or not keys.is_contiguous()
            or keys.numel() != mixture_key_words(spec, rounds)):
        raise ValueError(
            "keys must be the contiguous int32 buffer of "
            "mixture_source_keys for this spec and round count"
        )
    if partition not in ("strided", "blocked"):
        raise ValueError(
            f"partition must be 'strided' or 'blocked', got {partition!r}"
        )
    _check_lane_source(rank, world, num_samples, positions)
    if positions is not None:
        if not (isinstance(positions, torch.Tensor)
                and positions.dtype == torch.int64
                and positions.device.type == "cuda"
                and (keys is None or positions.device == keys.device)
                and positions.is_contiguous() and positions.dim() == 1):
            raise ValueError(
                f"positions must be a contiguous 1-D int64 tensor on "
                f"{dev if keys is None else keys.device}"
            )
        dev = positions.device
        lanes, rank, world = positions.numel(), 0, 1
    else:
        if not 0 <= rank < world:
            raise ValueError(f"rank must be in [0, {world}), got {rank}")
        lanes = int(num_samples)
    if not wide_pos and lanes > core.INT32_MAX:
        raise ValueError(
            f"{lanes} lanes need uint64 positions (wide_pos=True)"
        )
    out = torch.empty(lanes, dtype=spec.out_dtype(), device=dev)
    if lanes == 0:
        return out
    # the scalars (or the triple) are read only where the keys are derived
    lo, hi, ep, seeds = ((0, 0, 0, None) if keys is not None
                         else _launch_keys(seed, epoch, triple, out.device))
    lib = _load("mixture")
    pattern, prefix, src = mixture_tables(spec, out.device)
    stream = torch.cuda.current_stream(out.device).cuda_stream
    launches["mixture_fused"] += 1
    _check("mixture_fused", lib.psds_mixture_fused(
        out.data_ptr(), None if positions is None else positions.data_ptr(),
        lanes, rank, world, int(partition == "strided"), spec.block,
        spec.num_sources, pattern.data_ptr(), prefix.data_ptr(),
        src.data_ptr(), None if keys is None else keys.data_ptr(), lo, hi,
        ep, seeds, rounds, int(bool(shuffle)), int(bool(order_windows)),
        int(spec.rotated(shuffle)), int(bool(wide_pos)),
        int(spec.out_dtype() == torch.int64), stream,
    ))
    return out


# ---------------------------------------------------------------- shards
shard_row_keys_ref = shard.shard_row_keys_ref
shard_expand_ref = shard.shard_expand_ref


def _check_shard_args(sids: torch.Tensor, device: torch.device, w: int,
                      rounds: int) -> None:
    if not (sids.dtype == torch.int32 and sids.dim() == 1
            and sids.is_contiguous() and sids.device == device):
        raise ValueError(
            f"shard ids must be a contiguous 1-D int32 tensor on {device}")
    if not 0 <= w <= core.INT32_MAX:
        raise ValueError(f"window must be in [0, 2^31), got {w}")
    _check_rounds(rounds)


def shard_row_keys(sids: torch.Tensor, tables, seed, epoch, *, full: bool,
                   w: int, rounds: int = core.DEFAULT_ROUNDS,
                   sizes_out: bool = False, triple=None) -> tuple:
    """The row records of the shard stream ``sids`` (``shard_row_keys_ref``)
    on ``sids``' device, from the scalars or the seed triple: int32
    [R * shard.row_words(rounds)], and with ``sizes_out`` each row's shard
    size (int64 [R]; None otherwise on CUDA).  ``tables`` is the
    ``shard.shard_tables`` of the sizes on that device."""
    seed_p, epoch_p = _plain_keys(seed, epoch, triple)
    if device_kind(sids.device) == "cpu":
        return shard_row_keys_ref(sids, tables.dev_sizes, seed_p, epoch_p,
                                  full=full, w=w, rounds=rounds)
    _check_shard_args(sids, tables.device, w, rounds)
    rows = sids.numel()
    rowtab = torch.empty(rows * shard.row_words(rounds), dtype=torch.int32,
                         device=sids.device)
    m_of = (torch.empty(rows, dtype=torch.int64, device=sids.device)
            if sizes_out else None)
    if rows == 0:
        return rowtab, m_of
    lib = _load("shard")
    lo, hi, ep, seeds = _launch_keys(seed, epoch, triple, sids.device)
    stream = torch.cuda.current_stream(sids.device).cuda_stream
    launches["shard_row_keys"] += 1
    _check("shard_row_keys", lib.psds_shard_row_keys(
        rowtab.data_ptr(), None if m_of is None else m_of.data_ptr(),
        sids.data_ptr(), rows, tables.dev_sizes.data_ptr(), w, int(full),
        rounds, lo, hi, ep, seeds, stream,
    ))
    return rowtab, m_of


def shard_expand(rowtab, sids: torch.Tensor, tables,
                 ends: "torch.Tensor | None", *, lanes: int, full: bool,
                 w: int, rounds: int = core.DEFAULT_ROUNDS) -> torch.Tensor:
    """The expansion of the shard stream ``sids`` on ``sids``' device
    (``shard_expand_ref``): ``lanes`` global sample indices in stream
    order, int32, or int64 when the whole shard space sums past 2^31.
    ``rowtab`` is the ``shard_row_keys`` records of ``sids``; sequential
    mode (``shard.sequential``) reads none and takes None.  ``ends`` is the
    inclusive prefix of the rows' sizes (int64 [R]), or None when every
    shard has ``tables.m_uniform`` samples."""
    kw = dict(lanes=lanes, full=full, w=w, rounds=rounds)
    seq = shard.sequential(full, w)
    if device_kind(sids.device) == "cpu":
        return shard_expand_ref(None if seq else rowtab, sids,
                                tables.dev_offsets, ends,
                                m_uniform=tables.m_uniform,
                                out_dtype=tables.out_dtype, **kw)
    _check_shard_args(sids, tables.device, w, rounds)
    rows = sids.numel()
    if not seq and not (
            isinstance(rowtab, torch.Tensor) and rowtab.dtype == torch.int32
            and rowtab.is_contiguous() and rowtab.device == sids.device
            and rowtab.numel() == rows * shard.row_words(rounds)):
        raise ValueError("rowtab must be the shard_row_keys records of sids "
                         "for this round count")
    if ends is None:
        if tables.m_uniform is None or lanes != rows * tables.m_uniform:
            raise ValueError("ends=None takes uniform shard sizes and "
                             "lanes = rows * size")
    elif not (ends.dtype == torch.int64 and ends.is_contiguous()
              and ends.shape == (rows,) and ends.device == sids.device):
        raise ValueError(f"ends must be a contiguous int64 [{rows}] tensor "
                         f"on {sids.device}")
    out = torch.empty(lanes, dtype=tables.out_dtype, device=sids.device)
    if lanes == 0:
        return out
    # t / m in the kernel's lane width (uint64 past 2^31 - 1 lanes), u / w
    m_magic = fastdiv.magic(tables.m_uniform or 1,
                            64 if lanes > core.INT32_MAX else 32)
    w_magic = fastdiv.magic(max(w, 1))
    lib = _load("shard")
    stream = torch.cuda.current_stream(sids.device).cuda_stream
    launches["shard_expand"] += 1
    _check("shard_expand", lib.psds_shard_expand(
        out.data_ptr(), sids.data_ptr(), tables.dev_offsets.data_ptr(),
        None if ends is None else ends.data_ptr(),
        None if seq else rowtab.data_ptr(), lanes, rows,
        tables.m_uniform or 0, *m_magic, w, *w_magic, int(full), rounds,
        int(tables.out_dtype == torch.int64), stream,
    ))
    return out


# --------------------------------------------------------------- sampling
#: uint64 words of one alias column in the device table
#: (``csrc/sampling_kernels.cu`` COL_WORDS): the acceptance threshold, the
#: alias column | mix32(j ^ C_SRC) << 32, the source's size n_j, its magic
#: multiplier and packed shifts (32- or 64-bit, by the widest source), the
#: source's first id, its full-window length (n_j // W) * W, and a pad word
COL_WORDS = 8
#: columns a block of ``weighted_stream`` stages in shared memory at most
#: (``csrc/sampling_kernels.cu`` STAGE_COLS); past it the lanes read the
#: table through the read-only cache
STAGE_COLS = 256
#: cached device alias tables: (table.key(), sizes, window, device) -> tensor
_weighted_tables: dict = {}
_WEIGHTED_TABLES_CAP = 16


def weighted_plan(table, sizes: tuple, window: int) -> np.ndarray:
    """The device alias table of ``table`` over ``sizes`` for the window
    ``window`` as uint64 words, ``COL_WORDS`` a column (pure)."""
    from ..sampling import alias

    sizes = tuple(int(n) for n in sizes)
    bits = 64 if max(sizes) > core.INT32_MAX else 32
    offs, _total = alias.source_offsets(sizes)
    words = []
    for j, n in enumerate(sizes):
        _n, mult, shift = _divisor(n, bits)
        src = core.mix32(j ^ alias._C_SRC)
        words += [table.probs[j], table.alias[j] | (src << 32), n, mult,
                  shift, offs[j], (n // window) * window, 0]
    return np.array(words, dtype=np.uint64)


def weighted_table(table, sizes: tuple, window: int, device) -> torch.Tensor:
    """``weighted_plan`` as an int64 tensor (the uint64 bits) on ``device``,
    built once per ``(table.key(), sizes, window, device)`` and cached, so
    a regen of a known table copies nothing to the card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    sizes = tuple(int(n) for n in sizes)
    key = (table.key(), sizes, int(window), str(device))
    tab = _weighted_tables.get(key)
    if tab is None:
        words = weighted_plan(table, sizes, int(window))
        tab = torch.from_numpy(words.view(np.int64)).to(device)
        if len(_weighted_tables) >= _WEIGHTED_TABLES_CAP:
            _weighted_tables.pop(next(iter(_weighted_tables)))
        _weighted_tables[key] = tab
    return tab


def weighted_stream_ref(table, source_sizes, seed, epoch, *,
                        epoch_samples=None, rank=None, world=None,
                        num_samples=None, partition: str = "strided",
                        chain=None, positions=None, window: int,
                        shuffle: bool = True,
                        rounds: int = core.DEFAULT_ROUNDS, retry: int = 0,
                        device=None) -> torch.Tensor:
    """The plain version of ``weighted_stream(_wide)`` on ``device`` (the
    ordinals' device when they are given): the given ordinals, or the
    rank's ordinals (``sampling.alias.rank_ordinals``, through ``chain``
    when given); then ``sampling.alias.weighted_stream_at_generic``."""
    from ..sampling import alias

    if positions is None:
        positions = alias.rank_ordinals(epoch_samples, rank, world,
                                        num_samples, partition, chain, device)
    return alias.weighted_stream_at_generic(
        positions, table, source_sizes, seed, epoch, window=window,
        shuffle=shuffle, rounds=rounds, retry=retry)


def _check_weighted_source(epoch_samples, rank, world, num_samples, chain,
                           positions, wide: bool) -> None:
    """Ordinals come from ``positions`` (the wide kernel only) or from
    ``(epoch_samples, rank, world, num_samples[, chain])``."""
    if positions is not None:
        if any(v is not None for v in (epoch_samples, rank, world,
                                       num_samples, chain)):
            raise ValueError("pass positions, or epoch_samples, rank, world "
                             "and num_samples, not both")
        if not (isinstance(positions, torch.Tensor)
                and positions.dtype == torch.int64):
            raise ValueError("positions must be an int64 tensor")
        return
    if any(v is None for v in (epoch_samples, rank, world, num_samples)):
        raise ValueError("pass positions, or epoch_samples, rank, world and "
                         "num_samples")
    _check_width(int(epoch_samples), wide)
    if not 1 <= world <= core.INT32_MAX:
        raise ValueError(f"world must be in [1, 2^31), got {world}")
    if not 0 <= rank < world:
        raise ValueError(f"rank must be in [0, {world}), got {rank}")
    if num_samples < 0:
        raise ValueError(f"num_samples must be >= 0, got {num_samples}")


def _weighted(wide: bool, table, source_sizes, seed, epoch, *,
              epoch_samples, rank, world, num_samples, partition: str,
              chain, positions, window: int, shuffle: bool, rounds: int,
              retry: int, device) -> torch.Tensor:
    from ..sampling import alias

    name = "weighted_stream_wide" if wide else "weighted_stream"
    sizes = tuple(int(n) for n in source_sizes)
    if len(table.probs) != len(sizes):
        raise ValueError(
            f"table has {len(table.probs)} columns for {len(sizes)} sources")
    if positions is None:
        rank, world, num_samples = (int(v) if v is not None else None
                                    for v in (rank, world, num_samples))
    _check_weighted_source(epoch_samples, rank, world, num_samples, chain,
                           positions, wide)
    if shuffle:
        alias.check_window(sizes, window)
        if window > core.INT32_MAX:
            raise ValueError("window must be < 2^31")
    if chain is not None:
        chain = _as_chain(chain)
        first = chain_plan(int(epoch_samples), chain, partition, wide)[1]
    elif partition not in ("strided", "blocked"):
        raise ValueError(
            f"partition must be 'strided' or 'blocked', got {partition!r}")
    dev = positions.device if positions is not None else torch.device(device)
    law = dict(window=window, shuffle=shuffle, rounds=rounds, retry=retry)
    if device_kind(dev) == "cpu":
        return weighted_stream_ref(
            table, sizes, seed, epoch, epoch_samples=epoch_samples,
            rank=rank, world=world, num_samples=num_samples,
            partition=partition, chain=chain, positions=positions,
            device=dev, **law)
    _check_rounds(rounds)
    if positions is not None:
        p = positions.contiguous()
        lanes, first = p.numel(), (0, 0, 0)
        rank, world, layers, depth = 0, 1, None, 0
    else:
        lanes, p = num_samples, None
        if chain is None:
            first = tuple(_divisor(int(epoch_samples), 64 if wide else 32))
            layers, depth = None, 0
        else:
            layers, depth = chain_table(int(epoch_samples), chain, partition,
                                        dev), len(chain)
    out = torch.empty(lanes, dtype=alias.out_dtype(sizes), device=dev)
    if lanes == 0:
        return out
    W = int(window) if shuffle else 1
    tab = weighted_table(table, sizes, W, out.device)
    acc64 = table.total > core.INT32_MAX
    loc64 = max(sizes) > core.INT32_MAX
    _t, t_mult, t_shift = _divisor(table.total, 64 if acc64 else 32)
    _s, s_mult, s_shift = _divisor(len(sizes), 32)
    _w, w_mult, w_shift = _divisor(W, 64 if loc64 else 32)
    lo, hi, ep = core.seed_triple(seed, epoch)
    lib = _load("sampling")
    stream = torch.cuda.current_stream(out.device).cuda_stream
    fn = lib.psds_weighted_stream_wide if wide else lib.psds_weighted_stream
    launches[name] += 1
    _check(name, fn(
        out.data_ptr(), None if p is None else p.data_ptr(), lanes,
        tab.data_ptr(), len(sizes), int(len(sizes) <= STAGE_COLS), *first,
        world, rank, int(partition == "strided"),
        None if layers is None else layers.data_ptr(), depth, table.total,
        t_mult, t_shift, s_mult, s_shift, W, w_mult, w_shift, lo, hi, ep,
        int(retry) & core._M32, int(bool(shuffle)), int(acc64), int(loc64),
        int(out.dtype == torch.int64), rounds, stream,
    ))
    return out


def weighted_stream(table, source_sizes, seed, epoch, *, epoch_samples=None,
                    rank=None, world=None, num_samples=None,
                    partition: str = "strided", chain=None, window: int,
                    shuffle: bool = True, rounds: int = core.DEFAULT_ROUNDS,
                    retry: int = 0, device="cuda") -> torch.Tensor:
    """The alias law (``sampling/alias.py``) on uint32 ordinals, an epoch
    of ``epoch_samples`` < 2^31 draws: the rank's ``num_samples`` ordinals
    (``rank``, ``world``, ``partition``), or with ``chain`` (the
    outermost-first reshard layers of ``core.elastic_chain``) its remainder
    ordinals composed in the kernel, on ``device``.  ``retry`` folds a
    dedup retry round into the key.  int32 ids, or int64 when the sources
    total 2^31 or more."""
    return _weighted(False, table, source_sizes, seed, epoch,
                     epoch_samples=epoch_samples, rank=rank, world=world,
                     num_samples=num_samples, partition=partition,
                     chain=chain, positions=None, window=window,
                     shuffle=shuffle, rounds=rounds, retry=retry,
                     device=device)


def weighted_stream_wide(table, source_sizes, seed, epoch, *,
                         epoch_samples=None, rank=None, world=None,
                         num_samples=None, partition: str = "strided",
                         chain=None, positions=None, window: int,
                         shuffle: bool = True,
                         rounds: int = core.DEFAULT_ROUNDS, retry: int = 0,
                         device="cuda") -> torch.Tensor:
    """``weighted_stream`` on uint64 ordinals: an epoch of 2^31 draws or
    more, or the given int64 ``positions`` (1-D, on the launch device) read
    as uint64 bits and taken as they are."""
    return _weighted(True, table, source_sizes, seed, epoch,
                     epoch_samples=epoch_samples, rank=rank, world=world,
                     num_samples=num_samples, partition=partition,
                     chain=chain, positions=positions, window=window,
                     shuffle=shuffle, rounds=rounds, retry=retry,
                     device=device)
