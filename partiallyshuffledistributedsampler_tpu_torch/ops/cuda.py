"""The on-device index generator: one rank's epoch indices on the card.

``epoch_indices_cuda`` is the entry point the sampler and the device
iterator call.  On a CUDA device it always launches the hand-written
kernels of ``ops/cuda_kernel.py``:

* the amortized route (strided, shuffled, ``window % world == 0``, at
  least one full window, and for n >= 2^31 ``ceil(n / world) < 2^31``):
  one launch of ``index_amortized``, which runs the window-order
  bijection once per window slot of each tile and one bijection per
  element;
* every other config: ``index_general``, the full law per element.

Index spaces n >= 2^31 take the ``_wide`` form of each index kernel and
come out as int64 (``core.out_dtype``).  The seed may come as scalars or
as a seed triple tensor on the card (``triple``, the output of the seed
agreement in ``parallel/``).

``stream_indices_at_cuda`` (random access) and ``elastic_indices_cuda``
(the remainder epoch after a reshard) launch ``index_positions`` (or its
``_wide`` form): the law on given positions, or on the rank's remainder
positions composed through the reshard chain inside the kernel.

On a CPU device the same routing runs the kernels' plain versions, which
is what the CPU tests use.

``build_evaluator`` is the plain torch evaluator of a static config, on
any device, with the same amortized/general routing.

The regen and the remainder run inside the telemetry spans
``psds_epoch_regen`` and ``psds_elastic_regen`` (the JAX package's names
and attributes, ``ops/xla.py``) and a profiler range of the same name.  A
span times the host call only (the launch): it never waits for the card.
"""

from __future__ import annotations

import numbers

import torch

from ..telemetry import span as _span
from . import core, cuda_kernel


def _attr(v):
    """A span attribute from a scalar argument: the int, or None for a
    key read from a device triple (never a read of device memory)."""
    return int(v) if isinstance(v, numbers.Integral) else None


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
    device,
):
    """The plain torch evaluator ``fn(seed, epoch, rank) -> indices`` of a
    static config on ``device`` (required: the plain law runs wherever it
    is asked to): the amortized form where it applies (and ``amortize``),
    else the general per-element law."""
    num_samples, _ = core.shard_sizes(n, world, drop_last)
    if bool(amortize) and _amortized_applicable(
        n, window, world, shuffle, partition
    ):
        def fn(seed, epoch, rank):
            return cuda_kernel.epoch_indices_amortized_ref(
                n, window, seed, epoch, rank, world, num_samples,
                order_windows=order_windows, rounds=rounds, device=device,
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
    triple=None,
) -> torch.Tensor:
    """Rank's epoch indices on ``device`` (default: the current CUDA
    device): int32, or int64 when n >= 2^31.  The kernels are launched on
    the current stream and not waited for.  ``amortize=False`` forces the
    general kernel (the value is identical).  ``triple`` (with ``seed``
    and ``epoch`` None) is the seed triple as an int32[3] tensor on
    ``device``, read by the kernels from device memory."""
    n, window, world, rank = int(n), int(window), int(world), int(rank)
    _check_args(n, window, rank, world)
    if partition not in ("strided", "blocked"):
        raise ValueError(
            f"partition must be 'strided' or 'blocked', got {partition!r}"
        )
    core.check_index_space(n, window)
    wide = core.is_wide(n)
    # host span and profiler range share one name, as the JAX package's
    # span and device annotation do
    with _span("psds_epoch_regen", n=n, world=world), \
            torch.profiler.record_function("psds_epoch_regen"):
        if amortize and _amortized_applicable(n, window, world, shuffle,
                                              partition):
            amortized = (cuda_kernel.index_amortized_wide if wide
                         else cuda_kernel.index_amortized)
            return amortized(
                n, window, seed, epoch, rank, world, drop_last=drop_last,
                order_windows=order_windows, rounds=rounds, device=device,
                triple=triple,
            )
        general = (cuda_kernel.index_general_wide if wide
                   else cuda_kernel.index_general)
        return general(
            n, window, seed, epoch, rank, world, shuffle=shuffle,
            drop_last=drop_last, order_windows=order_windows,
            partition=partition, rounds=rounds, device=device, triple=triple,
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
    device="cuda",
) -> torch.Tensor:
    """Random access into the epoch stream (SPEC.md §4) on ``device``
    (default: the current CUDA device; ``positions`` are moved there, as
    int64): ``stream(p) = pi(p mod n)``, the positions taken as uint32
    (n < 2^31) or uint64 bits as the reference casts them; int32, or
    int64 when n >= 2^31.  One ``index_positions(_wide)`` launch."""
    n, window = int(n), int(window)
    cuda_kernel.device_kind(device)
    core.check_index_space(n, window)
    positions = torch.as_tensor(positions).to(device=device,
                                              dtype=torch.int64)
    kernel = (cuda_kernel.index_positions_wide if core.is_wide(n)
              else cuda_kernel.index_positions)
    with torch.profiler.record_function("psds_stream_at"):
        return kernel(n, window, seed, epoch, positions=positions,
                      shuffle=shuffle, order_windows=order_windows,
                      rounds=rounds)


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
    triple=None,
) -> torch.Tensor:
    """Rank's elastic-remainder-epoch indices (SPEC.md §6) on ``device``:
    one ``index_positions(_wide)`` launch, which composes the chain per
    lane.  ``chain`` is the outermost-first tuple of (world, num_samples,
    consumed) reshard layers from ``core.elastic_chain``.  ``triple``
    (with ``seed`` and ``epoch`` None) is the seed triple as an int32[3]
    tensor on ``device``, read by the kernel from device memory."""
    cuda_kernel.device_kind(device)
    kernel = (cuda_kernel.index_positions_wide if core.is_wide(int(n))
              else cuda_kernel.index_positions)
    with _span("psds_elastic_regen", epoch=_attr(epoch),
               rank=_attr(rank)), \
            torch.profiler.record_function("psds_elastic_regen"):
        return kernel(n, window, seed, epoch, rank=rank, world=world,
                      num_samples=num_samples, chain=chain,
                      partition=partition, shuffle=shuffle,
                      order_windows=order_windows, rounds=rounds,
                      device=device, triple=triple)
