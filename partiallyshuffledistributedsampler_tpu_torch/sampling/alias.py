"""Importance-weighted window sampling: exact-integer alias tables.

The weighted stream maps draw ordinals ``p`` to global sample ids in one
O(1) random-access step, as the windowed permutation maps positions to
indices: no cumulative tables, no rejection loops, no state.  Three hash
draws per lane decide everything:

* a **column** draw picks one of the ``S`` alias columns uniformly;
* an **accept** draw against the column's integer threshold keeps the
  column or takes its alias (Walker/Vose, built in exact Python-int
  arithmetic, so ``P(source s) = mass_s / total`` with no round-off);
* a **local** draw places the sample inside the chosen source, and the
  within-window offset then goes through the same ``swap_or_not``
  bijection the windowed permutation uses (``core.inner_key`` /
  ``core.inner_pair_key``).

The JAX package's law, draw for draw (its ``sampling/alias.py``): the same
table and the same ordinals give the same ids.  On a CUDA device the
``_cuda`` entry points launch ``weighted_stream`` (uint32 ordinals, the
epoch below 2^31) or ``weighted_stream_wide`` (uint64 ordinals) of
``ops/cuda_kernel.py``, one launch a call; the ``_cpu`` ones run
``weighted_stream_at_generic``, the kernels' plain version.

Lanes hold uint32 values in int64, as ``ops/core.py`` does; ordinals are
int64 tensors read as uint64 bits (a negative one stands for x + 2^64).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import core
from ..telemetry import profiler_range

__all__ = [
    "AliasTable", "build_alias_table",
    "weighted_stream_at_generic", "rank_ordinals",
    "weighted_epoch_indices_generic", "weighted_elastic_indices_generic",
    "weighted_epoch_indices_cpu", "weighted_epoch_indices_cuda",
    "weighted_elastic_indices_cpu", "weighted_elastic_indices_cuda",
    "weighted_stream_at_cpu", "weighted_stream_at_cuda",
]

#: columns cap: the table rides the spec wire form and the kernel reads one
#: column a lane, so S is a config knob, not a data axis
_MAX_SOURCES = 4096

# round constants of the per-ordinal hash streams (disjoint from the core
# key-schedule constants)
_C_POS = 0x7FEB352D
_C_POSH = 0x846CA68B
_C_SEL = 0x9E485565
_C_ACC = 0xAF36D01E
_C_ACC2 = 0x4A7B92D5
_C_LOC = 0x6C62272E
_C_LOC2 = 0x35A4E1B1
_C_SRC = 0xB5297A4D
_C_RETRY = 0x68E31DA4

_I31 = 0x7FFFFFFF
_I63 = 0x7FFFFFFFFFFFFFFF
_M32 = 0xFFFFFFFF


@dataclass(frozen=True)
class AliasTable:
    """One Walker/Vose alias table in exact integer arithmetic.

    ``probs[j]`` is column ``j``'s acceptance threshold in ``[0, total]``
    (``total`` = the exact mass sum): an accept draw ``u ~ U[0, total)``
    keeps ``j`` iff ``u < probs[j]``, else takes ``alias[j]``.  ``masses``
    records the per-source masses the table encodes."""

    probs: tuple
    alias: tuple
    total: int
    masses: tuple

    def key(self) -> tuple:
        """Hashable identity for device-table caches."""
        return (self.probs, self.alias, self.total)


def build_alias_table(weights, weight_kind: str,
                      source_sizes) -> AliasTable:
    """The exact-integer alias table for ``weights`` over ``source_sizes``.

    ``weight_kind='per_source'`` gives source ``s`` total mass ``w_s``;
    ``'per_sample'`` gives mass ``w_s * n_s``.  Weights are non-negative
    integer quotas, at least one positive.  Pure and deterministic: the
    masses are reduced by their GCD (proportional weights build the
    identical table), and the small/large pairing walks ascending column
    order."""
    sizes = tuple(int(n) for n in source_sizes)
    if not sizes:
        raise ValueError("source_sizes must name at least one source")
    if len(sizes) > _MAX_SOURCES:
        raise ValueError(
            f"at most {_MAX_SOURCES} sources, got {len(sizes)}")
    if any(n < 1 for n in sizes):
        raise ValueError(f"source sizes must be >= 1, got {sizes}")
    w = tuple(int(x) for x in weights)
    if len(w) != len(sizes):
        raise ValueError(
            f"{len(w)} weights for {len(sizes)} sources")
    if any(x < 0 for x in w):
        raise ValueError(f"weights must be >= 0, got {w}")
    if weight_kind == "per_source":
        masses = w
    elif weight_kind == "per_sample":
        masses = tuple(x * n for x, n in zip(w, sizes))
    else:
        raise ValueError(
            f"weight_kind must be 'per_source' or 'per_sample', "
            f"got {weight_kind!r}")
    total = sum(masses)
    if total <= 0:
        raise ValueError("weights sum to zero mass; nothing to sample")
    g = 0
    for m in masses:
        g = math.gcd(g, m)
    if g > 1:
        masses = tuple(m // g for m in masses)
        total //= g
    S = len(masses)
    if total > _I63 // max(S, 1):
        raise ValueError("total sampling mass too large (>= 2^63 / S)")
    # Vose in Python ints: each mass scaled by S, so the per-column
    # average is exactly ``total``
    scaled = [m * S for m in masses]
    probs = [total] * S
    alias = list(range(S))
    small = [j for j in range(S) if scaled[j] < total]
    large = [j for j in range(S) if scaled[j] >= total]
    while small and large:
        s, l = small.pop(), large.pop()
        probs[s] = scaled[s]
        alias[s] = l
        scaled[l] -= total - scaled[s]
        (small if scaled[l] < total else large).append(l)
    return AliasTable(probs=tuple(probs), alias=tuple(alias),
                      total=int(total), masses=masses)


def source_offsets(source_sizes) -> tuple:
    """``(offsets, total)``: each source's first global id, and the id
    space's size."""
    offs, acc = [], 0
    for n in source_sizes:
        offs.append(acc)
        acc += int(n)
    return tuple(offs), acc


def out_dtype(source_sizes) -> torch.dtype:
    """int32 ids, or int64 when the sources total 2^31 or more."""
    return torch.int64 if sum(int(n) for n in source_sizes) > _I31 \
        else torch.int32


def check_window(source_sizes, window: int) -> None:
    """What the within-window bijection refuses."""
    W = int(window)
    if W < 1:
        raise ValueError(f"window must be >= 1, got {W}")
    if any(int(n) // W > _M32 for n in source_sizes):
        raise ValueError("source window count must fit in uint32")


def as_positions(positions, device=None) -> torch.Tensor:
    """Draw ordinals as an int64 tensor of their uint64 bits on ``device``
    (a tensor's own device when None): numpy unsigned arrays are viewed,
    signed ones and Python ints taken as two's complement."""
    if isinstance(positions, torch.Tensor):
        return positions.to(device=device or positions.device,
                            dtype=torch.int64)
    a = np.asarray(positions)
    a = (a.astype(np.uint64).view(np.int64) if a.dtype.kind == "u"
         else a.astype(np.int64))
    return torch.from_numpy(np.ascontiguousarray(a)).to(device or "cpu")


# ------------------------------------------------------------- lane math
def _lane(idx: torch.Tensor, values) -> torch.Tensor:
    """``values[idx]`` per lane: one gather from a small tensor."""
    return torch.tensor(values, dtype=torch.int64, device=idx.device)[idx]


def _u64_word(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """``hi << 32 | lo`` of two uint32 lanes, as the int64 bits of the
    uint64 word (exact: no product leaves int64)."""
    return torch.where(hi > _I31, hi - (1 << 32), hi) * (1 << 32) + lo


def _draw64(base, c_hi: int, c_lo: int, modulus) -> torch.Tensor:
    """A 64-bit hash draw mod ``modulus`` (up to 2^63 - 1; an int or an
    int64 tensor)."""
    word = _u64_word(core.mix32(base ^ c_hi), core.mix32(base ^ c_lo))
    return core.u64_divmod(word, modulus)[1]


def weighted_stream_at_generic(
    positions: torch.Tensor,
    table: AliasTable,
    source_sizes,
    seed,
    epoch,
    *,
    window: int,
    shuffle: bool = True,
    rounds: int = core.DEFAULT_ROUNDS,
    retry: int = 0,
) -> torch.Tensor:
    """Map draw ordinals to global sample ids on the ordinals' device: the
    weighted stream's random-access primitive.

    ``positions`` holds draw ordinals as int64 (uint64 bits; callers wrap
    them mod the epoch length).  ``retry`` folds a dedup retry round into
    the key schedule: round 0 is the base draw, rounds >= 1 re-draw
    collisions (``sampling/dedup.py``).  int32 ids, or int64 when the
    sources total 2^31 or more."""
    sizes = tuple(int(n) for n in source_sizes)
    S = len(sizes)
    if len(table.probs) != S:
        raise ValueError(
            f"table has {len(table.probs)} columns for {S} sources")
    offs, _total_n = source_offsets(sizes)

    ek = core.derive_epoch_key(seed, epoch)
    if int(retry):
        ek = core.mix32(ek ^ core.mix32((int(retry) ^ _C_RETRY) & _M32))

    p = as_positions(positions)
    p_lo, p_hi = p & _M32, (p >> 32) & _M32
    base = core.mix32(ek ^ core.mix32(p_lo ^ _C_POS)
                      ^ core.mix32(p_hi ^ _C_POSH))

    # column draw + exact-integer accept test
    j = core.mix32(base ^ _C_SEL) % S
    if table.total > _I31:
        u = _draw64(base, _C_ACC, _C_ACC2, table.total)
    else:
        u = core.mix32(base ^ _C_ACC) % table.total
    j = torch.where(u < _lane(j, table.probs), j, _lane(j, table.alias))

    # within-source draw: a full 64-bit word where a source passes 2^31
    n_lane = _lane(j, sizes)
    if max(sizes) > _I31:
        local = _draw64(base, _C_LOC, _C_LOC2, n_lane)
    else:
        local = core.mix32(base ^ _C_LOC) % n_lane

    if shuffle:
        check_window(sizes, window)
        W = int(window)
        # full-window lanes route their offset through swap_or_not under
        # the source-and-window key; tail lanes keep the hashed draw
        body = _lane(j, tuple((n // W) * W for n in sizes))
        off, win = local % W, local // W
        eks = core.mix32(ek ^ core.mix32(j ^ _C_SRC))
        rho = core.swap_or_not(off, W, core.inner_key(eks, win), rounds,
                               pair_key=core.inner_pair_key(ek))
        local = torch.where(local < body, win * W + rho, local)

    return (_lane(j, offs) + local).to(out_dtype(sizes))


# --------------------------------------------------------- epoch streams
def _check_rank(rank: int, world: int) -> None:
    if int(world) < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    if not 0 <= int(rank) < int(world):
        raise ValueError(f"rank must be in [0, {world}), got {rank}")


def rank_ordinals(epoch_samples: int, rank: int, world: int,
                  num_samples: int, partition: str, chain=None,
                  device=None) -> torch.Tensor:
    """The rank's draw ordinals (int64) on ``device``: its ``num_samples``
    positions of the epoch, mod ``epoch_samples``; or with ``chain`` (the
    outermost-first layers of ``core.elastic_chain``) its positions over
    the innermost remainder, composed out through the chain and wrapped mod
    ``epoch_samples``."""
    T = int(epoch_samples)
    wide = core.is_wide(T)
    if chain is None:
        return core.rank_positions(T, rank, world, num_samples, partition,
                                   wide, device)
    w_last, ns_last, c_last = chain[-1]
    q = core.rank_positions((ns_last - c_last) * w_last, rank, world,
                            num_samples, partition, wide, device)
    return core.compose_remainder_chain(q, chain, partition, wide) % T


def weighted_epoch_indices_generic(
    table, source_sizes, seed, epoch, rank, world, *, epoch_samples,
    window, shuffle=True, drop_last=False, partition="strided",
    rounds=core.DEFAULT_ROUNDS, device=None,
):
    """Rank's full weighted epoch stream on ``device``: ``epoch_samples``
    draw ordinals partitioned by the shared rank-position law
    (wrap-padding included), each mapped through the alias law."""
    T = int(epoch_samples)
    if T < 1:
        raise ValueError(f"epoch_samples must be >= 1, got {T}")
    _check_rank(rank, world)
    num_samples, _ = core.shard_sizes(T, world, drop_last)
    p = rank_ordinals(T, int(rank), int(world), num_samples, partition,
                      device=device)
    return weighted_stream_at_generic(
        p, table, source_sizes, seed, epoch,
        window=window, shuffle=shuffle, rounds=rounds)


def weighted_elastic_indices_generic(
    table, source_sizes, seed, epoch, rank, world, layers, *,
    epoch_samples, window, shuffle=True, drop_last=False,
    partition="strided", rounds=core.DEFAULT_ROUNDS, device=None,
):
    """Rank's weighted remainder stream after a §6 elastic cascade on
    ``device``: the shared remainder law composed with the alias law
    (ordinals wrap mod the epoch length like plain-mode positions)."""
    T = int(epoch_samples)
    chain, remaining, num_samples = core.elastic_chain(
        T, layers, world, drop_last)
    _check_rank(rank, world)
    if remaining == 0 or num_samples == 0:
        return torch.empty(0, dtype=out_dtype(source_sizes), device=device)
    pos = rank_ordinals(T, int(rank), int(world), num_samples, partition,
                        chain, device)
    return weighted_stream_at_generic(
        pos, table, source_sizes, seed, epoch,
        window=window, shuffle=shuffle, rounds=rounds)


# ------------------------------------------------------------ entry points
def weighted_epoch_indices_cpu(table, source_sizes, seed, epoch, rank,
                               world, **kw) -> torch.Tensor:
    """The rank's weighted epoch stream on the host (the plain law)."""
    return weighted_epoch_indices_generic(
        table, source_sizes, seed, epoch, rank, world, device="cpu", **kw)


def weighted_elastic_indices_cpu(table, source_sizes, seed, epoch, rank,
                                 world, layers, **kw) -> torch.Tensor:
    """The rank's weighted remainder stream on the host (the plain law)."""
    return weighted_elastic_indices_generic(
        table, source_sizes, seed, epoch, rank, world, layers,
        device="cpu", **kw)


def weighted_stream_at_cpu(positions, table, source_sizes, seed, epoch,
                           **kw) -> torch.Tensor:
    """Random access into the weighted stream on the host: ``positions``
    are draw ordinals (uint64 bits of int64, or numpy unsigned)."""
    return weighted_stream_at_generic(
        as_positions(positions, "cpu"), table, source_sizes, seed, epoch,
        **kw)


def kernel_for(epoch_samples: int):
    """The weighted kernel wrapper of an epoch of ``epoch_samples`` draws:
    ``weighted_stream`` (uint32 ordinals) below 2^31, else
    ``weighted_stream_wide``."""
    from ..ops import cuda_kernel as ck

    return (ck.weighted_stream_wide if core.is_wide(epoch_samples)
            else ck.weighted_stream)


def weighted_epoch_indices_cuda(
    table, source_sizes, seed, epoch, rank, world, *, epoch_samples,
    window, shuffle=True, drop_last=False, partition="strided",
    rounds=core.DEFAULT_ROUNDS, device="cuda",
) -> torch.Tensor:
    """The rank's weighted epoch stream on ``device`` (default: the current
    CUDA device), on the current stream and not waited for: one launch of
    ``weighted_stream`` (``_wide`` for an epoch of 2^31 draws or more),
    which computes the rank's ordinals itself."""
    T = int(epoch_samples)
    if T < 1:
        raise ValueError(f"epoch_samples must be >= 1, got {T}")
    _check_rank(rank, world)
    num_samples, _ = core.shard_sizes(T, world, drop_last)
    with profiler_range("psds_weighted_regen"):
        return kernel_for(T)(
            table, source_sizes, seed, epoch, epoch_samples=T,
            window=window, shuffle=shuffle, rounds=rounds, rank=int(rank),
            world=int(world), num_samples=num_samples, partition=partition,
            device=device)


def weighted_elastic_indices_cuda(
    table, source_sizes, seed, epoch, rank, world, layers, *,
    epoch_samples, window, shuffle=True, drop_last=False,
    partition="strided", rounds=core.DEFAULT_ROUNDS, device="cuda",
) -> torch.Tensor:
    """The rank's weighted remainder stream after the cascade ``layers``
    on ``device``: one ``weighted_stream(_wide)`` launch, which composes
    the reshard chain per lane from the cached device table
    (``cuda_kernel.chain_table``) and wraps the ordinal mod the epoch."""
    from ..ops import cuda_kernel as ck

    T = int(epoch_samples)
    chain, remaining, num_samples = core.elastic_chain(
        T, layers, world, drop_last)
    _check_rank(rank, world)
    if remaining == 0 or num_samples == 0:
        ck.device_kind(device)
        return torch.empty(0, dtype=out_dtype(source_sizes), device=device)
    with profiler_range("psds_weighted_elastic_regen"):
        return kernel_for(T)(
            table, source_sizes, seed, epoch, epoch_samples=T,
            window=window, shuffle=shuffle, rounds=rounds, rank=int(rank),
            world=int(world), num_samples=num_samples, chain=chain,
            partition=partition, device=device)


def weighted_stream_at_cuda(positions, table, source_sizes, seed, epoch, *,
                            window, shuffle=True,
                            rounds=core.DEFAULT_ROUNDS, retry=0,
                            device="cuda") -> torch.Tensor:
    """Random access into the weighted stream on ``device``: the ordinals
    (moved there as int64, read as uint64) through one
    ``weighted_stream_wide`` launch."""
    from ..ops import cuda_kernel as ck

    ck.device_kind(device)
    p = as_positions(positions, torch.device(device))
    with profiler_range("psds_weighted_at"):
        return ck.weighted_stream_wide(
            table, source_sizes, seed, epoch, positions=p, window=window,
            shuffle=shuffle, rounds=rounds, retry=retry)
