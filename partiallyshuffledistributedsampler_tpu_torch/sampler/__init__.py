"""The torch ``Sampler`` surface, device-resident epoch iteration and the
prefetching loader over host-resident data."""

from .device_iterator import (  # noqa: F401
    DeviceEpochIterator,
    MixtureEpochIterator,
    batch_index_window,
)
from .host_loader import HostDataLoader  # noqa: F401
from .mixture import PartialShuffleMixtureSampler  # noqa: F401
from .shard_mode import (  # noqa: F401
    PartialShuffleShardSampler,
    expand_shard_indices,
    expand_shard_indices_cpu,
    expand_shard_indices_cuda,
    expand_shard_indices_generic,
    shard_sample_order,
    shard_seed,
    shuffle_buffer,
)
from .stateful_loader import StatefulDataLoader  # noqa: F401
from .torch_shim import PartiallyShuffleDistributedSampler  # noqa: F401
