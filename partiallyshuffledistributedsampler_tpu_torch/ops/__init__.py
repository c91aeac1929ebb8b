"""Permutation primitives: the law core, its CPU reference and the CUDA
index kernels."""

import numpy as np

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

def ensure_index_backend(backend: str) -> None:
    """Validate at construction that ``backend`` ('cpu' | 'cuda') can
    serve: 'cuda' without a usable GPU raises ``CudaUnavailableError``
    here, never one epoch into a run and never by running on the CPU."""
    if backend in ("native", "xla"):
        raise ValueError(
            f"backend {backend!r} belongs to the JAX package "
            "partiallyshuffledistributedsampler_tpu; this package serves "
            "'cpu' and 'cuda'"
        )
    if backend not in ("cpu", "cuda"):
        raise ValueError(f"backend must be 'cpu' or 'cuda', got {backend!r}")
    if backend == "cuda":
        require_cuda()


def epoch_indices_host(backend: str, n, window, seed, epoch, rank, world,
                       **kwargs) -> np.ndarray:
    """One rank's epoch indices as a host numpy array via ``backend``:
    'cuda' runs the kernels and reads back once, 'cpu' the reference."""
    ensure_index_backend(backend)
    if backend == "cuda":
        return epoch_indices_cuda(
            n, window, seed, epoch, rank, world, **kwargs
        ).cpu().numpy()
    return epoch_indices_cpu(n, window, seed, epoch, rank, world,
                             **kwargs).numpy()
