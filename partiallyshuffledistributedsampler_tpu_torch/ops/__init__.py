"""Permutation primitives: the law core, its CPU reference, the weighted
mixture (SPEC.md §8), the CUDA kernels and the native C++ host kernel."""

import numpy as np
import torch

from .core import (  # noqa: F401
    DEFAULT_ROUNDS,
    DEFAULT_WINDOW,
    derive_epoch_key,
    epoch_indices_generic,
    mix32,
    shard_sizes,
    swap_or_not,
    windowed_perm,
)
from .cpu import (  # noqa: F401
    elastic_indices_cpu,
    epoch_indices_cpu,
    full_epoch_stream_cpu,
    stream_indices_at_cpu,
)
from .cuda import (  # noqa: F401
    elastic_indices_cuda,
    epoch_indices_cuda,
    stream_indices_at_cuda,
)
from .cuda_kernel import CudaUnavailableError, require_cuda  # noqa: F401
from .mixture import (  # noqa: F401
    DEFAULT_BLOCK,
    MixtureSpec,
    build_mixture_evaluator,
    mixture_elastic_indices_cpu,
    mixture_elastic_indices_cuda,
    mixture_epoch_indices_cpu,
    mixture_epoch_indices_cuda,
    mixture_epoch_sizes,
    mixture_stream_at_cpu,
    mixture_stream_at_cuda,
    source_seed,
)

def ensure_index_backend(backend: str) -> None:
    """Validate at construction that ``backend`` ('cpu' | 'native' |
    'cuda') can serve: 'cuda' without a usable GPU raises
    ``CudaUnavailableError`` here, never one epoch into a run and never by
    running on the CPU; 'native' loads the C++ host library, building it
    with ``g++`` if needed, and raises ``RuntimeError`` when that fails.
    'auto' is resolved by the caller before it gets here."""
    if backend == "xla":
        raise ValueError(
            "backend 'xla' belongs to the JAX package "
            "partiallyshuffledistributedsampler_tpu; this package serves "
            "'cpu', 'native' and 'cuda'"
        )
    if backend not in ("cpu", "native", "cuda"):
        raise ValueError(
            f"backend must be 'cpu', 'native' or 'cuda', got {backend!r}")
    if backend == "cuda":
        require_cuda()
    elif backend == "native":
        from . import native

        native._load()


def resolve_host_backend() -> str:
    """The host-side 'auto' rule of every stream whose cost the measured
    single-source model cannot price (mixture, shard mode, the spec): the
    native C++ kernel when it loads, the CPU route otherwise."""
    from . import native

    return "native" if native.available() else "cpu"


def host_array(t: torch.Tensor) -> np.ndarray:
    """``t`` as a host numpy array.  A CUDA tensor is read back once: a
    ``non_blocking`` copy into pinned memory on the current stream, which
    the host then waits for.  A pageable copy faults in fresh pages and
    copies synchronously, which held up other threads' copies to the
    card."""
    if not t.is_cuda:
        return t.numpy()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return out.numpy()


def epoch_indices_host(backend: str, n, window, seed, epoch, rank, world,
                       **kwargs) -> np.ndarray:
    """One rank's epoch indices as a host numpy array via ``backend``:
    'cuda' runs the kernels and reads back once, 'native' the C++ host
    kernel, 'cpu' the reference."""
    ensure_index_backend(backend)
    if backend == "cuda":
        return host_array(epoch_indices_cuda(
            n, window, seed, epoch, rank, world, **kwargs))
    if backend == "native":
        from .native import epoch_indices_native

        return epoch_indices_native(n, window, seed, epoch, rank, world,
                                    **kwargs)
    return epoch_indices_cpu(n, window, seed, epoch, rank, world,
                             **kwargs).numpy()
