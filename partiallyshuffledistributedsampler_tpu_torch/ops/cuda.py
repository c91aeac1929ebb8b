"""The on-device index generator: one rank's epoch indices on the card.

``epoch_indices_cuda`` is the entry point the sampler and the device
iterator call.  On a CUDA device it always launches the hand-written
kernels of ``ops/cuda_kernel.py``:

* the amortized route (strided, shuffled, ``window % world == 0``, at
  least one full window): ``window_order_ids`` runs the window-order
  bijection once per window, then ``index_amortized`` runs one bijection
  per element;
* every other config: ``index_general``, the full law per element.

On a CPU device the same routing runs the kernels' plain versions, which
is what the CPU tests use.  ``stream_indices_at_cuda`` and
``elastic_indices_cuda`` are plain torch ops on the device of their
input: they are random-access reads, not the per-epoch hot path.

``build_evaluator`` is the plain torch evaluator of a static config, on
any device, with the same amortized/general routing.
"""

from __future__ import annotations

import torch

from . import core, cuda_kernel


def _amortized_applicable(n: int, window: int, world: int, shuffle: bool,
                          partition: str) -> bool:
    """The window-order bijection can be hoisted out of the per-element
    program when each rank's stream walks windows in whole runs: strided
    partition with ``window % world == 0`` gives every rank exactly
    ``m = window/world`` consecutive elements per window, so the outer
    swap-or-not runs once per *window* instead of once per *element*.
    Bit-identical to the law by algebra.

    For n >= 2^31 the bijections still run in uint32 (window ids, offsets
    and per-rank stream offsets all fit) and only the final combine widens,
    so amortization applies there too while each stays in uint32 range.
    """
    if not (
        shuffle
        and partition == "strided"
        and window % world == 0
        and n // window >= 1
    ):
        return False
    if n <= core.INT32_MAX:
        return True
    return (
        n // window <= core.INT32_MAX
        and window <= core.INT32_MAX
        and -(-n // world) <= core.INT32_MAX
    )


def _epoch_indices_amortized(n: int, window: int, seed, epoch, rank: int,
                             world: int, num_samples: int,
                             order_windows: bool, rounds: int,
                             device=None) -> torch.Tensor:
    """Rank's epoch indices by the plain amortized evaluation (the
    window-order pre-pass, then one bijection per element).  Same value
    as ``core.epoch_indices_generic``."""
    ku = cuda_kernel.window_order_ids_ref(
        n, window, seed, epoch, order_windows=order_windows, rounds=rounds,
        device=device,
    )
    return cuda_kernel.index_amortized_ref(
        ku, n, window, seed, epoch, rank, world, num_samples,
        order_windows=order_windows, rounds=rounds,
    )


def build_evaluator(
    n: int,
    window: int,
    world: int,
    *,
    shuffle: bool = True,
    drop_last: bool = False,
    order_windows: bool = True,
    partition: str = "strided",
    rounds: int = core.DEFAULT_ROUNDS,
    amortize: bool = True,
    device=None,
):
    """The plain torch evaluator ``fn(seed, epoch, rank) -> indices`` of a
    static config on ``device``: the amortized form where it applies
    (and ``amortize``), else the general per-element law."""
    num_samples, _ = core.shard_sizes(n, world, drop_last)
    if bool(amortize) and _amortized_applicable(
        n, window, world, shuffle, partition
    ):
        def fn(seed, epoch, rank):
            return _epoch_indices_amortized(
                n, window, seed, epoch, rank, world, num_samples,
                order_windows, rounds, device,
            )
    else:
        def fn(seed, epoch, rank):
            return core.epoch_indices_generic(
                n, window, seed, epoch, rank, world, shuffle=shuffle,
                drop_last=drop_last, order_windows=order_windows,
                partition=partition, rounds=rounds, device=device,
            )

    return fn


def _check_args(n: int, window: int, rank: int, world: int) -> None:
    if int(window) < 1:
        raise ValueError(f"window must be >= 1, got {int(window)}")
    if int(world) < 1:
        raise ValueError(f"world must be >= 1, got {int(world)}")
    if not 0 <= int(rank) < int(world):
        raise ValueError(f"rank must be in [0, {world}), got {int(rank)}")


def epoch_indices_cuda(
    n: int,
    window: int,
    seed,
    epoch,
    rank,
    world: int,
    *,
    shuffle: bool = True,
    drop_last: bool = False,
    order_windows: bool = True,
    partition: str = "strided",
    rounds: int = core.DEFAULT_ROUNDS,
    amortize: bool = True,
    device="cuda",
) -> torch.Tensor:
    """Rank's epoch indices as an int32 tensor on ``device`` (default: the
    current CUDA device).  The kernels are launched on the current stream
    and not waited for.  ``amortize=False`` forces the general kernel (the
    value is identical).  Index spaces n >= 2^31 raise: they have no
    kernel yet."""
    n, window, world, rank = int(n), int(window), int(world), int(rank)
    _check_args(n, window, rank, world)
    if partition not in ("strided", "blocked"):
        raise ValueError(
            f"partition must be 'strided' or 'blocked', got {partition!r}"
        )
    cuda_kernel.require_int32_index_space(n)
    with torch.profiler.record_function("psds_epoch_regen"):
        if amortize and _amortized_applicable(n, window, world, shuffle,
                                              partition):
            ku = cuda_kernel.window_order_ids(
                n, window, seed, epoch, order_windows=order_windows,
                rounds=rounds, device=device,
            )
            return cuda_kernel.index_amortized(
                ku, n, window, seed, epoch, rank, world, drop_last=drop_last,
                order_windows=order_windows, rounds=rounds,
            )
        return cuda_kernel.index_general(
            n, window, seed, epoch, rank, world, shuffle=shuffle,
            drop_last=drop_last, order_windows=order_windows,
            partition=partition, rounds=rounds, device=device,
        )


def stream_indices_at_cuda(
    positions: torch.Tensor,
    n: int,
    window: int,
    seed,
    epoch,
    *,
    shuffle: bool = True,
    order_windows: bool = True,
    rounds: int = core.DEFAULT_ROUNDS,
) -> torch.Tensor:
    """Random access into the epoch stream (SPEC.md §4) on the device of
    ``positions``."""
    return core.stream_indices_at_generic(
        positions, int(n), int(window), seed, epoch, shuffle=shuffle,
        order_windows=order_windows, rounds=rounds,
    )


def elastic_indices_cuda(
    n: int,
    window: int,
    seed,
    epoch,
    rank,
    world: int,
    num_samples: int,
    chain,
    *,
    shuffle: bool = True,
    order_windows: bool = True,
    partition: str = "strided",
    rounds: int = core.DEFAULT_ROUNDS,
    device="cuda",
) -> torch.Tensor:
    """Rank's elastic-remainder-epoch indices (SPEC.md §6) on ``device``.
    ``chain`` is the outermost-first tuple of (world, num_samples,
    consumed) reshard layers from ``core.elastic_chain``."""
    if torch.device(device).type == "cuda":
        cuda_kernel.require_cuda()
    with torch.profiler.record_function("psds_elastic_regen"):
        return core.elastic_indices_generic(
            int(n), int(window), seed, epoch, int(rank), int(world),
            int(num_samples), chain, shuffle=shuffle,
            order_windows=order_windows, partition=partition, rounds=rounds,
            device=device,
        )
