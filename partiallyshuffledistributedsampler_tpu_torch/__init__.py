"""partiallyshuffledistributedsampler_tpu_torch: on-GPU partial-shuffle
distributed sampling in PyTorch and CUDA.

Each rank's windowed-shuffle epoch index tensor is generated on an NVIDIA
GPU by hand-written CUDA kernels (``ops/cuda_kernel.py``), behind the
``torch.utils.data.Sampler`` surface and a device-resident batch iterator.
The law is the one frozen in ``SPEC.md``: the same
``(n, window, seed, epoch, rank, world, flags)`` gives the same indices as
the JAX package ``partiallyshuffledistributedsampler_tpu``, and the
sampler checkpoints of the two packages are interchangeable.  The weighted
multi-corpus mixture (SPEC.md §8: ``MixtureSpec``,
``PartialShuffleMixtureSampler``, ``MixtureEpochIterator``) and
shard-index mode (SPEC.md §7: ``PartialShuffleShardSampler``,
``expand_shard_indices_cuda``) run on the card through their own kernels.
Data that lives in host memory reaches the card through
``HostDataLoader`` (pinned gathers, asynchronous copies), whose stream is
a ``PartialShuffleSpec`` (or, moving-horizon, a ``StreamSpec``; weighted,
prioritized or dedup, a ``SamplingSpec``) with the JAX package's wire
form.  ``backend="native"`` runs the law in the package's own C++ host
kernel and ``backend="auto"`` picks a backend by the JAX package's rule.
The consumers that train from device-resident indices (a GPT and a ViT,
the train step and the whole-run runners) are in ``models/``; runnable
examples in ``examples/``.
"""

from .ops import (  # noqa: F401
    DEFAULT_ROUNDS,
    DEFAULT_WINDOW,
    DEFAULT_BLOCK,
    CudaUnavailableError,
    MixtureSpec,
    elastic_indices_cpu,
    elastic_indices_cuda,
    ensure_index_backend,
    epoch_indices_cpu,
    epoch_indices_cuda,
    epoch_indices_host,
    full_epoch_stream_cpu,
    mixture_elastic_indices_cpu,
    mixture_elastic_indices_cuda,
    mixture_epoch_indices_cpu,
    mixture_epoch_indices_cuda,
    mixture_stream_at_cpu,
    mixture_stream_at_cuda,
    shard_sizes,
    stream_indices_at_cpu,
    stream_indices_at_cuda,
)
from .sampler import (  # noqa: F401
    DeviceEpochIterator,
    HostDataLoader,
    MixtureEpochIterator,
    PartialShuffleMixtureSampler,
    PartialShuffleShardSampler,
    PartiallyShuffleDistributedSampler,
    StatefulDataLoader,
    batch_index_window,
    expand_shard_indices,
    expand_shard_indices_cpu,
    expand_shard_indices_cuda,
    expand_shard_indices_generic,
    shard_sample_order,
    shard_seed,
    shuffle_buffer,
)
from .sampling import SamplingSpec  # noqa: F401
from .service import PartialShuffleSpec  # noqa: F401
from .streaming import StreamSpec  # noqa: F401
from .utils.metrics import RegenTimer  # noqa: F401
from .utils.stall_probe import StallProbe  # noqa: F401
from .utils.watchdog import StallError  # noqa: F401
