"""CPU reference backend: the law of ``ops/core.py`` on CPU tensors.

The ground truth of the port, bit-identical to the numpy reference of the
JAX package by construction (same law, same constants).  Every function
returns a CPU tensor of int32 (int64 when n >= 2^31).
"""

from __future__ import annotations

import torch

from . import core


def epoch_indices_cpu(
    n: int,
    window: int,
    seed: int,
    epoch: int,
    rank: int,
    world: int,
    *,
    shuffle: bool = True,
    drop_last: bool = False,
    order_windows: bool = True,
    partition: str = "strided",
    rounds: int = core.DEFAULT_ROUNDS,
) -> torch.Tensor:
    """Rank's epoch indices on the host: int32[num_samples]."""
    if not 0 <= rank < world:
        raise ValueError(f"rank must be in [0, {world}), got {rank}")
    return core.epoch_indices_generic(
        n, window, int(seed), int(epoch), int(rank), world,
        shuffle=shuffle, drop_last=drop_last, order_windows=order_windows,
        partition=partition, rounds=rounds, device="cpu",
    )


def stream_indices_at_cpu(
    positions,
    n: int,
    window: int,
    seed: int,
    epoch: int,
    *,
    shuffle: bool = True,
    order_windows: bool = True,
    rounds: int = core.DEFAULT_ROUNDS,
) -> torch.Tensor:
    """Random access into the epoch stream (SPEC.md §4) on the host.

    ``stream_indices_at_cpu(rank + world*torch.arange(k), ...)`` reproduces
    the first k entries of ``epoch_indices_cpu(...)``."""
    return core.stream_indices_at_generic(
        torch.as_tensor(positions, device="cpu"), n, window, int(seed),
        int(epoch), shuffle=shuffle, order_windows=order_windows,
        rounds=rounds,
    )


def full_epoch_stream_cpu(
    n: int,
    window: int,
    seed: int,
    epoch: int,
    *,
    world: int = 1,
    drop_last: bool = False,
    order_windows: bool = True,
    rounds: int = core.DEFAULT_ROUNDS,
) -> torch.Tensor:
    """The entire padded epoch stream (all ranks interleaved) — the
    interleave of every rank's strided shard, for invariant tests."""
    _num_samples, total = core.shard_sizes(n, world, drop_last)
    p = torch.arange(total, dtype=torch.int64) % n
    ek = core.derive_epoch_key(int(seed), int(epoch))
    return core.windowed_perm(
        p, n, window, ek, order_windows=order_windows, rounds=rounds,
    ).to(core.out_dtype(n))


def elastic_indices_cpu(
    n: int,
    window: int,
    seed,
    epoch: int,
    rank: int,
    world: int,
    layers,
    *,
    shuffle: bool = True,
    drop_last: bool = False,
    order_windows: bool = True,
    partition: str = "strided",
    rounds: int = core.DEFAULT_ROUNDS,
) -> torch.Tensor:
    """Rank's elastic remainder-epoch indices on the host (SPEC.md §6/§6.1).

    ``layers`` is the checkpoint cascade ``[(world, consumed), ...]``
    outermost first; sizing and validation via ``core.elastic_chain``.
    """
    chain, remaining, num_samples = core.elastic_chain(
        n, layers, world, drop_last
    )
    if remaining == 0 or num_samples == 0:
        return torch.empty(0, dtype=core.out_dtype(n))
    return core.elastic_indices_generic(
        n, window, seed, epoch, rank, world, num_samples, chain,
        shuffle=shuffle, order_windows=order_windows, partition=partition,
        rounds=rounds, device="cpu",
    )

