"""Epochless moving-horizon shuffle over an append-only index space.

Samples become eligible when appended and are shuffled within a sliding
**horizon** by the same windowed-permutation kernels (docs/STREAMING.md).
:class:`StreamSpec` is the sampler-side value object; ``HostDataLoader``
serves it with ``streaming=True``.
"""

from .spec import StreamSpec, WEIGHTS_RETAIN  # noqa: F401

__all__ = ["StreamSpec", "WEIGHTS_RETAIN"]
