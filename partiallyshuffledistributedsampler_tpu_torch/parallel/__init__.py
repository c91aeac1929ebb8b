"""Seed agreement over a process group and per-rank shard regen.

The JAX package's ``parallel/`` minus its mixture functions
(``sharded_mixture_indices``, ``make_mixture_regen_fn``,
``sharded_mixture_elastic_indices``), which wait for the mixture port.
"""

from .mesh import (  # noqa: F401
    data_mesh,
    ensure_distributed,
    identity_from_mesh,
    local_ranks_from_mesh,
)
from .sharded import (  # noqa: F401
    make_elastic_regen_fn,
    make_regen_fn,
    make_seed_triple,
    sharded_elastic_indices,
    sharded_epoch_indices,
)
