"""Seed agreement over a process group and per-rank shard regen, for the
single-source stream and the weighted mixture (SPEC.md §8)."""

from .mesh import (  # noqa: F401
    data_mesh,
    ensure_distributed,
    identity_from_mesh,
    local_ranks_from_mesh,
)
from .sharded import (  # noqa: F401
    make_elastic_regen_fn,
    make_mixture_regen_fn,
    make_regen_fn,
    make_seed_triple,
    sharded_elastic_indices,
    sharded_epoch_indices,
    sharded_mixture_elastic_indices,
    sharded_mixture_indices,
)
