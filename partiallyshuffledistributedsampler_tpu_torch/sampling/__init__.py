"""Non-uniform sampling: weighted, prioritized and dedup streams.

Three sampling modes, packaged as :class:`SamplingSpec`, a drop-in
:class:`~..service.spec.PartialShuffleSpec` with the JAX package's wire
form: ``weighted`` (static importance weights through an exact-integer
alias table), ``prioritized`` (per-epoch adopted weights) and ``dedup``
(a deterministic seeded seen-set that suppresses repeats across epochs).
On the card the alias law runs in the hand-written ``weighted_stream``
kernels (``ops/cuda_kernel.py``, ``csrc/sampling_kernels.cu``).
"""

from .alias import (
    AliasTable,
    build_alias_table,
    weighted_elastic_indices_cpu,
    weighted_elastic_indices_cuda,
    weighted_elastic_indices_generic,
    weighted_epoch_indices_cpu,
    weighted_epoch_indices_cuda,
    weighted_epoch_indices_generic,
    weighted_stream_at_cpu,
    weighted_stream_at_cuda,
    weighted_stream_at_generic,
)
from .dedup import (
    BloomSeen,
    ExactSeen,
    dedup_check,
    fold_candidates,
    fold_epoch,
    make_seen,
    restore_seen,
)
from .spec import SAMPLING_MODES, SamplingSpec

__all__ = [
    "AliasTable",
    "BloomSeen",
    "ExactSeen",
    "SAMPLING_MODES",
    "SamplingSpec",
    "build_alias_table",
    "dedup_check",
    "fold_candidates",
    "fold_epoch",
    "make_seen",
    "restore_seen",
    "weighted_elastic_indices_cpu",
    "weighted_elastic_indices_cuda",
    "weighted_elastic_indices_generic",
    "weighted_epoch_indices_cpu",
    "weighted_epoch_indices_cuda",
    "weighted_epoch_indices_generic",
    "weighted_stream_at_cpu",
    "weighted_stream_at_cuda",
    "weighted_stream_at_generic",
]
