"""The torch ``Sampler`` surface and device-resident epoch iteration."""

from .device_iterator import (  # noqa: F401
    DeviceEpochIterator,
    MixtureEpochIterator,
    batch_index_window,
)
from .mixture import PartialShuffleMixtureSampler  # noqa: F401
from .stateful_loader import StatefulDataLoader  # noqa: F401
from .torch_shim import PartiallyShuffleDistributedSampler  # noqa: F401
