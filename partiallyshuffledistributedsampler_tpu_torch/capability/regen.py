"""Membership-trail replay: ONE implementation for both regen paths.

Capability-mode regeneration (docs/CAPABILITY.md) and the degraded
fallback (``ServiceIndexClient.local_epoch_indices``,
docs/RESILIENCE.md) compose the same stream: each membership a client
delivered under contributes the prefix it actually served, and the
current membership contributes its remainder, with rank 0 prepending
any orphan descriptors for the epoch.  Both paths delegate here so they
cannot drift — a divergence would silently fork the data a checkpoint
resumes into.

These helpers are pure: they evaluate a ``PartialShuffleSpec`` (passed
in; this package imports nothing from ``service``) against explicit
membership facts, which is exactly the shape a verified
:class:`~.token.EpochCapability` or an adopted client membership
provides.  Any spec of the port rides here (plain, mixture, shard,
``StreamSpec``, ``SamplingSpec``): its ``rank_indices`` hands back host
numpy, so the composition stays on the host.  On ``backend="cuda"`` a
membership's stream is one kernel regen at that membership's world (a
``with_world`` of the spec) and one readback.
"""

from __future__ import annotations

import numpy as np


def orphan_slice(spec, o: dict) -> np.ndarray:
    """Materialise one orphan descriptor against ``spec`` — the same
    law the server applies when serving rank 0's prefix."""
    layers = [tuple(map(int, l)) for l in o.get("layers", [])] or None
    s = spec.with_world(int(o["world"]))
    arr = np.asarray(s.rank_indices(int(o["epoch"]), int(o["rank"]),
                                    layers=layers))
    return arr[int(o["lo"]):int(o["hi"])]


def membership_stream(spec, epoch: int, rank, world, layers,
                      orphans) -> np.ndarray:
    """One membership's stream for ``rank``: the §6 cascade under
    ``layers`` at ``world``, with rank 0 prepending this epoch's orphan
    descriptors.  A rank outside the world (vacated by a shrink) gets
    an empty stream."""
    epoch = int(epoch)
    if rank is None or world is None or int(rank) >= int(world):
        return np.empty(0, dtype=np.int64)
    s = spec.with_world(int(world))
    arr = np.asarray(s.rank_indices(
        epoch, int(rank),
        layers=[tuple(map(int, l)) for l in (layers or ())] or None,
    ))
    if int(rank) == 0 and orphans:
        pre = [orphan_slice(spec, o) for o in orphans
               if int(o["epoch"]) == epoch]
        if pre:
            arr = np.concatenate(pre + [arr])
    return arr


def replay_trail(spec, epoch: int, *, rank, world, layers, orphans,
                 elastic_epoch=None, trail=()) -> np.ndarray:
    """Compose the full epoch stream from a membership trail.

    For a non-elastic epoch (``elastic_epoch != epoch``) this is one
    plain stream under the current membership — no cascade applies, and
    the orphan filter inside :func:`membership_stream` drops other
    epochs' descriptors.  For the elastic epoch, each ``trail`` entry
    (``{"rank", "world", "layers", "orphans", "samples"}``) contributes
    the prefix it actually delivered, then the current membership
    contributes its full remainder — together bit-identical to what the
    service would have gone on to serve."""
    epoch = int(epoch)
    if elastic_epoch is None or int(elastic_epoch) != epoch:
        return membership_stream(spec, epoch, rank, world, [], orphans)
    parts = []
    for m in trail:
        parts.append(membership_stream(
            spec, epoch, m["rank"], m["world"], m["layers"],
            m["orphans"])[: int(m["samples"])])
    parts.append(membership_stream(spec, epoch, rank, world, layers,
                                   orphans))
    parts = [p for p in parts if len(p)]
    if not parts:
        return np.empty(0, dtype=np.int64)
    return np.concatenate(parts)
