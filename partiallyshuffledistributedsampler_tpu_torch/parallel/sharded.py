"""Seed agreement over a process group, then each rank's own shard.

The reference sampler relies on a convention: every rank builds the
sampler with the same ``seed`` and calls ``set_epoch`` with the same value.
Here each process contributes its own ``(seed_lo, seed_hi, epoch)`` triple
(``make_seed_triple``) and a broadcast from the group's rank 0 makes rank
0's triple the one every rank uses; each process then generates only its
own rank's shard of the epoch, O(n / world) per device, with no gather.
The JAX package does the same inside one program with a rank-0-masked
``psum`` over the mesh axis; the broadcast gives the same triple.

On the card the agreed triple stays in device memory: the broadcast writes
it there (NCCL) and the index kernels read it from there
(``ops/cuda_kernel.py``, ``triple=``), so nothing between the agreement and
the regen waits for the host.  The elastic remainder regen reads it the
same way (``index_positions``, which composes the reshard chain in the
kernel from a table put on the card when the regen function is made).

The mixture (SPEC.md §8) rides the same agreement: the agreed triple feeds
the mixture kernels (``mixture_fused``, or ``mixture_fused_wide`` for a
source of 2^31 or more and for ``fused=False``; ``mixture_source_keys``
first for a spec too large to fold), which XOR each source's seed offset
into the agreed halves on the card, the bitwise split of
``source_seed_folded``; the remainder positions of an elastic mixture
epoch are built with torch ops on the card before the kernel evaluates
them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops import core, cuda_kernel
from ..ops.cuda import elastic_indices_cuda, epoch_indices_cuda
from ..ops.cuda_kernel import device_kind
from ..ops.mixture import (
    _elastic_plan,
    mixture_elastic_indices_cuda,
    mixture_epoch_indices_cuda,
    mixture_epoch_sizes,
)
from .mesh import data_mesh, identity_from_mesh


def make_seed_triple(seed, epoch, *, mesh: Optional[DeviceMesh] = None,
                     local_seeds=None, device="cuda") -> torch.Tensor:
    """This process's seed triple: an int32[3] tensor holding the uint32
    bits of ``(seed_lo, seed_hi, epoch)``, on ``mesh``'s device type if a
    mesh is given, else on ``device``.  ``local_seeds``, this process's own
    ``(seed_lo, seed_hi, epoch)``, replaces ``seed`` and ``epoch``, as a
    row of the JAX package's per-device triple does.

    On the card the triple is copied from pinned memory without waiting,
    so making one is no host synchronisation."""
    kind = device_kind(mesh.device_type if mesh is not None else device)
    if local_seeds is None:
        bits = core.seed_triple(seed, epoch)
    else:
        bits = tuple(int(v) for v in local_seeds)
        if len(bits) != 3 or not all(0 <= v <= 0xFFFFFFFF for v in bits):
            raise ValueError(
                "local_seeds must be (seed_lo, seed_hi, epoch), each in "
                f"uint32 range, got {tuple(local_seeds)!r}"
            )
    host = torch.from_numpy(np.array(bits, dtype=np.uint32).view(np.int32))
    if kind == "cpu":
        return host
    return host.pin_memory().to(kind, non_blocking=True)


def _agree(triple: torch.Tensor, mesh: DeviceMesh, axis: str):
    """Rank 0's triple along ``axis``, on every rank of it: a broadcast
    from the group's rank 0 (``group_src``, not a global rank), the value
    of the JAX package's rank-0-masked ``psum``."""
    agreed = triple.clone()
    dist.broadcast(agreed, group=mesh.get_group(axis), group_src=0)
    return agreed


def _mesh_identity(mesh: Optional[DeviceMesh], axis: str):
    if mesh is None:
        mesh = data_mesh(axis_name=axis)
    world, rank = identity_from_mesh(mesh, axis)
    return mesh, world, rank


def make_regen_fn(
    n: int,
    window: int,
    *,
    mesh: Optional[DeviceMesh] = None,
    axis: str = "data",
    shuffle: bool = True,
    drop_last: bool = False,
    order_windows: bool = True,
    partition: str = "strided",
    rounds: int = core.DEFAULT_ROUNDS,
):
    """``(fn, num_samples)``: ``fn(triple)`` agrees on rank 0's triple over
    ``mesh``'s ``axis`` (default: ``data_mesh()`` on the card), then
    returns this process's row, its rank's epoch indices, generated by the
    index kernels from the agreed triple in device memory (the plain
    routing on a CPU mesh).  World and rank come from the mesh."""
    n, window = int(n), int(window)
    mesh, world, rank = _mesh_identity(mesh, axis)
    num_samples, _ = core.shard_sizes(n, world, drop_last)
    core.check_index_space(n, window)
    law = dict(shuffle=shuffle, drop_last=drop_last,
               order_windows=order_windows, partition=partition,
               rounds=rounds)

    def fn(triple: torch.Tensor) -> torch.Tensor:
        agreed = _agree(triple, mesh, axis)
        return epoch_indices_cuda(n, window, None, None, rank, world,
                                  device=mesh.device_type, triple=agreed,
                                  **law)

    return fn, num_samples


def sharded_epoch_indices(
    n: int,
    window: int,
    seed,
    epoch,
    *,
    mesh: Optional[DeviceMesh] = None,
    axis: str = "data",
    shuffle: bool = True,
    drop_last: bool = False,
    order_windows: bool = True,
    partition: str = "strided",
    rounds: int = core.DEFAULT_ROUNDS,
    local_seeds=None,
) -> torch.Tensor:
    """This rank's epoch indices under rank 0's seed: equal to
    ``epoch_indices_cuda(n, window, seed0, epoch0, rank, world)`` where
    ``(seed0, epoch0)`` are rank 0's.  ``local_seeds`` gives this process's
    own ``(seed_lo, seed_hi, epoch)`` in place of ``seed`` and ``epoch``;
    rank 0's wins."""
    mesh = mesh if mesh is not None else data_mesh(axis_name=axis)
    fn, _ = make_regen_fn(
        n, window, mesh=mesh, axis=axis, shuffle=shuffle,
        drop_last=drop_last, order_windows=order_windows,
        partition=partition, rounds=rounds,
    )
    return fn(make_seed_triple(seed, epoch, mesh=mesh,
                               local_seeds=local_seeds))


def make_elastic_regen_fn(
    n: int,
    window: int,
    layers,
    *,
    mesh: Optional[DeviceMesh] = None,
    axis: str = "data",
    shuffle: bool = True,
    drop_last: bool = False,
    order_windows: bool = True,
    partition: str = "strided",
    rounds: int = core.DEFAULT_ROUNDS,
):
    """``(fn, num_samples)`` of the remainder epoch (SPEC.md §6) after a
    world-size change: ``fn(triple)`` agrees on rank 0's triple, then
    returns this rank's share of the epoch's un-consumed stream.
    ``layers`` is the checkpoint cascade ``[(world, consumed), ...]``
    outermost first (``core.elastic_chain`` sizes and validates it).  An
    empty remainder gives ``(None, 0)``."""
    n, window = int(n), int(window)
    mesh, world, rank = _mesh_identity(mesh, axis)
    chain, _remaining, num_samples = core.elastic_chain(
        n, layers, world, drop_last
    )
    if num_samples == 0:
        return None, 0
    core.check_index_space(n, window)

    if mesh.device_type == "cuda":
        # the chain table goes to the card here, so a regen copies nothing
        cuda_kernel.chain_table(n, chain, partition, mesh.device_type)

    def fn(triple: torch.Tensor) -> torch.Tensor:
        return elastic_indices_cuda(
            n, window, None, None, rank, world, num_samples, chain,
            shuffle=shuffle, order_windows=order_windows,
            partition=partition, rounds=rounds, device=mesh.device_type,
            triple=_agree(triple, mesh, axis),
        )

    return fn, num_samples


def sharded_elastic_indices(
    n: int,
    window: int,
    seed,
    epoch,
    layers,
    *,
    mesh: Optional[DeviceMesh] = None,
    axis: str = "data",
    shuffle: bool = True,
    drop_last: bool = False,
    order_windows: bool = True,
    partition: str = "strided",
    rounds: int = core.DEFAULT_ROUNDS,
    local_seeds=None,
) -> torch.Tensor:
    """This rank's remainder-epoch indices under rank 0's seed (SPEC.md
    §6), equal to the sampler's ``reshard_from_state_dict`` stream for the
    same layers; an empty tensor of the index dtype when nothing
    remains."""
    mesh = mesh if mesh is not None else data_mesh(axis_name=axis)
    fn, _ = make_elastic_regen_fn(
        n, window, layers, mesh=mesh, axis=axis, shuffle=shuffle,
        drop_last=drop_last, order_windows=order_windows,
        partition=partition, rounds=rounds,
    )
    if fn is None:
        return torch.empty(0, dtype=core.out_dtype(int(n)),
                           device=mesh.device_type)
    return fn(make_seed_triple(seed, epoch, mesh=mesh,
                               local_seeds=local_seeds))


def make_mixture_regen_fn(
    spec,
    *,
    mesh: Optional[DeviceMesh] = None,
    axis: str = "data",
    epoch_samples=None,
    shuffle: bool = True,
    drop_last: bool = False,
    order_windows: bool = True,
    partition: str = "strided",
    rounds: int = core.DEFAULT_ROUNDS,
):
    """``(fn, num_samples)`` of the mixture stream (SPEC.md §8):
    ``fn(triple)`` agrees on rank 0's triple over ``mesh``'s ``axis``,
    then returns this process's row, its rank's mixture-epoch ids,
    generated by the mixture kernels from the agreed triple in device
    memory (the plain law on a CPU mesh).  Warns, as the JAX package does,
    when a strided world starves a source of a position-static pattern."""
    mesh, world, rank = _mesh_identity(mesh, axis)
    spec.check_world_balance(world, str(partition), bool(shuffle))
    _t, num_samples, _total = mixture_epoch_sizes(spec, epoch_samples, world,
                                                  drop_last)
    law = dict(epoch_samples=epoch_samples, shuffle=shuffle,
               drop_last=drop_last, order_windows=order_windows,
               partition=partition, rounds=rounds)
    if mesh.device_type == "cuda":
        # the spec's tables (both mixture kernels read them) go to the card
        # here, so a regen copies nothing
        cuda_kernel.mixture_tables(spec, mesh.device_type)

    def fn(triple: torch.Tensor) -> torch.Tensor:
        agreed = _agree(triple, mesh, axis)
        return mixture_epoch_indices_cuda(spec, None, None, rank, world,
                                          device=mesh.device_type,
                                          triple=agreed, **law)

    return fn, num_samples


def sharded_mixture_indices(
    spec,
    seed,
    epoch,
    *,
    mesh: Optional[DeviceMesh] = None,
    axis: str = "data",
    epoch_samples=None,
    shuffle: bool = True,
    drop_last: bool = False,
    order_windows: bool = True,
    partition: str = "strided",
    rounds: int = core.DEFAULT_ROUNDS,
    local_seeds=None,
) -> torch.Tensor:
    """This rank's mixture-epoch ids under rank 0's seed: equal to
    ``mixture_epoch_indices_cuda(spec, seed0, epoch0, rank, world)``
    where ``(seed0, epoch0)`` are rank 0's (``local_seeds`` as in
    :func:`sharded_epoch_indices`)."""
    mesh = mesh if mesh is not None else data_mesh(axis_name=axis)
    fn, _ = make_mixture_regen_fn(
        spec, mesh=mesh, axis=axis, epoch_samples=epoch_samples,
        shuffle=shuffle, drop_last=drop_last, order_windows=order_windows,
        partition=partition, rounds=rounds,
    )
    return fn(make_seed_triple(seed, epoch, mesh=mesh,
                               local_seeds=local_seeds))


def sharded_mixture_elastic_indices(
    spec,
    seed,
    epoch,
    layers,
    *,
    mesh: Optional[DeviceMesh] = None,
    axis: str = "data",
    epoch_samples=None,
    shuffle: bool = True,
    drop_last: bool = False,
    order_windows: bool = True,
    partition: str = "strided",
    rounds: int = core.DEFAULT_ROUNDS,
    local_seeds=None,
) -> torch.Tensor:
    """This rank's remainder-epoch mixture ids under rank 0's seed
    (SPEC.md §6 over §8), equal to the mixture sampler's
    ``reshard_from_state_dict`` stream for the same layers; an empty
    tensor of the id dtype when nothing remains."""
    mesh, world, rank = _mesh_identity(mesh, axis)
    spec.check_world_balance(world, str(partition), bool(shuffle))
    _chain, _rem, num_samples, _bt, _wide = _elastic_plan(
        spec, layers, world, epoch_samples, drop_last
    )
    if num_samples == 0:
        return torch.empty(0, dtype=spec.out_dtype(),
                           device=mesh.device_type)
    agreed = _agree(make_seed_triple(seed, epoch, mesh=mesh,
                                     local_seeds=local_seeds), mesh, axis)
    return mixture_elastic_indices_cuda(
        spec, None, None, rank, world, layers, epoch_samples=epoch_samples,
        shuffle=shuffle, drop_last=drop_last, order_windows=order_windows,
        partition=partition, rounds=rounds, device=mesh.device_type,
        triple=agreed,
    )
