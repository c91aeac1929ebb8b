"""Wrappers of the hand-written CUDA kernels in ``csrc/index_kernels.cu``.

Three kernels, each with a wrapper, a plain PyTorch version and a launch
counter:

=================  ====================================  =======================
wrapper            plain version                         replaces
=================  ====================================  =======================
window_order_ids   ``window_order_ids_ref``              ``ops/xla.py``
                                                         ``_window_order_ids``
index_general      ``index_general_ref``                 ``ops/pallas_kernel.py``
                   (= ``core.epoch_indices_generic``)    ``_index_kernel``
index_amortized    ``index_amortized_ref``               ``ops/pallas_kernel.py``
                   (the amortized evaluator)             ``_amortized_kernel``
=================  ====================================  =======================

(paths of the JAX package ``partiallyshuffledistributedsampler_tpu``).

A wrapper runs the plain version only for a CPU device, which is what the
CPU tests use; for a CUDA device it launches its kernel and raises on
anything the kernel does not take — there is no fallback.  ``launches``
counts kernel launches per wrapper, and nothing else.

The kernels are built with ``nvcc`` at first use into ``csrc/build/`` of
this package (named by a hash of the source, so an edited source rebuilds)
and bound through ctypes over a plain C ABI.  Nothing is built or imported
from CUDA when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Optional

import torch

from . import core

_CSRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc"
)
_SOURCE = os.path.join(_CSRC, "index_kernels.cu")
_BUILD_DIR = os.path.join(_CSRC, "build")
#: nvcc flags: Hopper's sm_90a, optimised, a shared library with a C ABI;
#: -Xptxas -v records registers and spills in ``build_log``
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: the kernels keep the per-round pairing constants in fixed shared arrays
MAX_ROUNDS = 64

#: kernel launches per wrapper (reset with ``reset_launches``)
launches = {"window_order_ids": 0, "index_general": 0, "index_amortized": 0}

_lib: Optional[ctypes.CDLL] = None
#: the compiler's output of the build this process loaded ("" if prebuilt)
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


def library_path() -> str:
    """Where the build of the current source lives."""
    with open(_SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(
        _BUILD_DIR, f"libpsds_index_kernels-{digest.hexdigest()[:16]}.so"
    )


def build() -> str:
    """Compile the kernels if this source has no build yet; return the .so
    path.  The library is written under a temporary name and renamed, so
    concurrent builds never load a half-written file."""
    global build_log
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, _SOURCE]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (exit {res.returncode}):\n{res.stderr[-4000:]}"
        )
    os.replace(tmp, so)
    build_log = res.stdout + res.stderr
    return so


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        u32, i32, ptr = ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p
        lib.psds_window_order_ids.argtypes = [
            ptr, u32, u32, u32, u32, u32, i32, i32, ptr,
        ]
        lib.psds_index_general.argtypes = [
            ptr, u32, u32, u32, u32, u32, u32, u32, u32, i32, i32, i32, i32,
            ptr,
        ]
        lib.psds_index_amortized.argtypes = [
            ptr, ptr, u32, u32, u32, u32, u32, u32, u32, u32, i32, i32, ptr,
        ]
        for fn in (lib.psds_window_order_ids, lib.psds_index_general,
                   lib.psds_index_amortized):
            fn.restype = i32
        _lib = lib
    return _lib


def _check(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def require_int32_index_space(n: int) -> None:
    if n > core.INT32_MAX:
        raise ValueError(
            f"the CUDA index kernels take n <= int32 max ({core.INT32_MAX}), "
            f"got n={n}; index spaces >= 2^31 have no kernel yet"
        )


def _device_kind(device) -> str:
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


def _scalars(seed, epoch) -> tuple:
    """(seed_lo, seed_hi, epoch) as the kernels' uint32 arguments."""
    lo, hi = core.fold_seed(seed)
    return int(lo), int(hi), int(epoch) & 0xFFFFFFFF


def _check_kernel_args(n: int, window: int, world: int, rounds: int) -> None:
    """What the kernels' uint32 arguments and fixed schedules can carry."""
    require_int32_index_space(n)
    for name, v in (("window", window), ("world", world)):
        if not 1 <= v <= core.INT32_MAX:
            raise ValueError(f"{name} must be in [1, 2^31), got {v}")
    if not 0 <= rounds <= MAX_ROUNDS:
        raise ValueError(f"rounds must be in [0, {MAX_ROUNDS}], got {rounds}")


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


#: the general law per lane
index_general_ref = core.epoch_indices_generic


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


# ---------------------------------------------------------------- kernels
def window_order_ids(n: int, window: int, seed, epoch, *,
                     order_windows: bool = True,
                     rounds: int = core.DEFAULT_ROUNDS,
                     device="cuda") -> torch.Tensor:
    """``ku`` for the amortized kernel: int32[n // window] on CUDA (the
    ids are below 2^31), int64 from the plain version on the CPU."""
    if _device_kind(device) == "cpu":
        return window_order_ids_ref(n, window, seed, epoch,
                                    order_windows=order_windows,
                                    rounds=rounds, device=device)
    _check_kernel_args(n, window, 1, rounds)
    if n // window < 1:
        raise ValueError(f"window {window} > n {n}: no full window to order")
    lo, hi, ep = _scalars(seed, epoch)
    lib = _load()
    ku = torch.empty(n // window, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(ku.device).cuda_stream
    launches["window_order_ids"] += 1
    _check("window_order_ids", lib.psds_window_order_ids(
        ku.data_ptr(), n, window, lo, hi, ep, int(bool(order_windows)),
        rounds, stream,
    ))
    return ku


def index_general(n: int, window: int, seed, epoch, rank: int, world: int,
                  *, shuffle: bool = True, drop_last: bool = False,
                  order_windows: bool = True, partition: str = "strided",
                  rounds: int = core.DEFAULT_ROUNDS,
                  device="cuda") -> torch.Tensor:
    """Rank's epoch indices by the general law: int32[num_samples]."""
    kwargs = dict(shuffle=shuffle, drop_last=drop_last,
                  order_windows=order_windows, partition=partition,
                  rounds=rounds)
    if _device_kind(device) == "cpu":
        return index_general_ref(n, window, seed, epoch, rank, world,
                                 device=device, **kwargs)
    _check_kernel_args(n, window, world, rounds)
    if partition not in ("strided", "blocked"):
        raise ValueError(
            f"partition must be 'strided' or 'blocked', got {partition!r}"
        )
    if not 0 <= rank < world:
        raise ValueError(f"rank must be in [0, {world}), got {rank}")
    num_samples, _ = core.shard_sizes(n, world, drop_last)
    lo, hi, ep = _scalars(seed, epoch)
    lib = _load()
    out = torch.empty(num_samples, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(out.device).cuda_stream
    launches["index_general"] += 1
    _check("index_general", lib.psds_index_general(
        out.data_ptr(), n, window, world, num_samples, rank, lo, hi, ep,
        int(bool(shuffle)), int(bool(order_windows)),
        int(partition == "strided"), rounds, stream,
    ))
    return out


def index_amortized(ku: torch.Tensor, n: int, window: int, seed, epoch,
                    rank: int, world: int, *, drop_last: bool = False,
                    order_windows: bool = True,
                    rounds: int = core.DEFAULT_ROUNDS) -> torch.Tensor:
    """Rank's epoch indices by the amortized law from the window-order ids
    ``ku`` (``window_order_ids``): int32[num_samples] on ``ku``'s device.
    Takes only strided, shuffled configs with ``window % world == 0`` and
    at least one full window."""
    num_samples, _ = core.shard_sizes(n, world, drop_last)
    if not (window % world == 0 and n // window >= 1):
        raise ValueError(
            f"the amortized law needs window % world == 0 and n >= window "
            f"(n={n}, window={window}, world={world})"
        )
    if ku.shape != (n // window,):
        raise ValueError(
            f"ku must hold n // window = {n // window} ids, got shape "
            f"{tuple(ku.shape)}"
        )
    if _device_kind(ku.device) == "cpu":
        return index_amortized_ref(ku, n, window, seed, epoch, rank, world,
                                   num_samples, order_windows=order_windows,
                                   rounds=rounds)
    _check_kernel_args(n, window, world, rounds)
    if ku.dtype != torch.int32 or not ku.is_contiguous():
        raise ValueError("ku must be a contiguous int32 tensor")
    if not 0 <= rank < world:
        raise ValueError(f"rank must be in [0, {world}), got {rank}")
    lo, hi, ep = _scalars(seed, epoch)
    lib = _load()
    out = torch.empty(num_samples, dtype=torch.int32, device=ku.device)
    stream = torch.cuda.current_stream(ku.device).cuda_stream
    launches["index_amortized"] += 1
    _check("index_amortized", lib.psds_index_amortized(
        out.data_ptr(), ku.data_ptr(), n, window, world, num_samples, rank,
        lo, hi, ep, int(bool(order_windows)), rounds, stream,
    ))
    return out
