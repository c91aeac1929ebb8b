"""Scale-out serving plane: shard the index service behind a rank-space
router (docs/SHARDING.md).

A copy of the JAX package's ``sharding/``: the same maps, frames, WAL
records, fault sites and lock names.  Each shard regenerates through its
spec's backend (on ``"cuda"`` the spec's kernels on the card, one
readback a regen), as the port's ``IndexServer`` does.

One ``IndexServer`` dispatch loop is a single-process ceiling; this
subsystem multiplies it.  A :class:`ShardMap` statically partitions the
spec's rank space into contiguous slices, one per shared-nothing
:class:`ShardServer` (a full ``IndexServer`` — leases, acks, epochs,
snapshots, replication and WAL all stay per-shard), and a thin
:class:`ShardRouter` fronts the plane: it answers HELLO with the map and
redirects every client to direct-connect its shard, so the steady-state
fused/pipelined serve path never proxies through it.  Cross-shard
``set_epoch`` and reshard barriers run two-phase (prepare/commit with a
map-version bump) through the router; :class:`ShardPlane` deploys the
whole topology in one call.
"""

from .plane import ShardPlane  # noqa: F401
from .router import ShardRouter  # noqa: F401
from .shardmap import ShardMap  # noqa: F401
from .shards import ShardServer  # noqa: F401
