"""partiallyshuffledistributedsampler_tpu_torch: on-GPU partial-shuffle
distributed sampling in PyTorch and CUDA.

Each rank's windowed-shuffle epoch index tensor is generated on an NVIDIA
GPU by hand-written CUDA kernels (``ops/cuda_kernel.py``), behind the
``torch.utils.data.Sampler`` surface and a device-resident batch iterator.
The law is the one frozen in ``SPEC.md``: the same
``(n, window, seed, epoch, rank, world, flags)`` gives the same indices as
the JAX package ``partiallyshuffledistributedsampler_tpu``, and the
sampler checkpoints of the two packages are interchangeable.
"""

from .ops import (  # noqa: F401
    DEFAULT_ROUNDS,
    DEFAULT_WINDOW,
    CudaUnavailableError,
    elastic_indices_cpu,
    elastic_indices_cuda,
    ensure_index_backend,
    epoch_indices_cpu,
    epoch_indices_cuda,
    epoch_indices_host,
    full_epoch_stream_cpu,
    shard_sizes,
    stream_indices_at_cpu,
    stream_indices_at_cuda,
)
from .sampler import (  # noqa: F401
    DeviceEpochIterator,
    PartiallyShuffleDistributedSampler,
    StatefulDataLoader,
    batch_index_window,
)
from .utils.metrics import RegenTimer  # noqa: F401
