"""The torch ``Sampler`` surface and device-resident epoch iteration."""

from .device_iterator import DeviceEpochIterator, batch_index_window  # noqa: F401
from .stateful_loader import StatefulDataLoader  # noqa: F401
from .torch_shim import PartiallyShuffleDistributedSampler  # noqa: F401
