"""The permutation law (SPEC.md) as PyTorch ops on a tensor of any device.

This is the single source of truth of the port: the CPU reference
(``ops/cpu.py``), the plain evaluators of ``ops/cuda.py`` and the plain
versions the CUDA kernels are checked against all run the functions
below.  The law itself is frozen in ``SPEC.md``; the constants are copied
literally and must never change.

Integer representation
----------------------
The law is exact uint32 arithmetic (uint64 for positions when n >= 2^31).
PyTorch's CPU backend implements only ``^`` and ``&`` for ``uint32``
tensors, so every lane here is an ``int64`` tensor holding a value in
``[0, 2^32)``, masked with ``& 0xFFFFFFFF`` after every ``+``, ``-``,
``*`` and ``<<`` that could leave that range:

* a sum or difference of two uint32 values fits int64 exactly, and the
  mask reproduces the uint32 wrap;
* a product of two values below 2^32 can exceed 2^63; PyTorch wraps int64
  products modulo 2^64, so the low 32 bits (all the mask keeps) are still
  exact (``tests/test_torch_port_core.py`` pins this down);
* ``>>`` of a non-negative value is the logical shift.

uint64 positions (n >= 2^31) are carried as plain int64: every position
the law computes is below n, far below 2^63 for any index space the
sampler takes.  A position given from outside (random access) may be any
int64; a negative one stands for its uint64 bits, x + 2^64, and
``u64_divmod`` divides it as such.

Scalars (keys, round constants) may be Python ints or 0-d tensors: every
function here works on both, so a key that depends only on (seed, epoch)
is computed once on the host and broadcast into the lanes.
"""

from __future__ import annotations

import math
from numbers import Integral

import torch

# ---------------------------------------------------------------------------
# Spec constants.  Frozen: changing any of these changes every permutation.
# ---------------------------------------------------------------------------
DEFAULT_ROUNDS = 24
DEFAULT_WINDOW = 4096

_GOLDEN = 0x9E3779B9  # 2^32 / phi — round-constant stride for round keys
_RC_BIT = 0x7FEB352D  # round-constant stride for the swap decision bit
_C_SEED_HI = 0x85EBCA6B
_C_EPOCH = 0xC2B2AE35
_C_OUTER = 0xA5A5A5A5
_C_INNER = 0x5A5A5A5A
_C_TAIL = 0x3C3C3C3C
_C_WIN = 0x27D4EB2F
_C_BIT = 0x94D049BB
_C_PAIR = 0x165667B1

_M32 = 0xFFFFFFFF
#: largest n whose positions and indices fit int32 (uint32 position math)
INT32_MAX = 0x7FFFFFFF


def _is_int(v) -> bool:
    """A concrete integer (Python or numpy), as opposed to a tensor."""
    return isinstance(v, Integral)


def is_wide(n: int) -> bool:
    """Whether positions of an index space of size ``n`` need uint64 math."""
    return int(n) > INT32_MAX


def out_dtype(n: int) -> torch.dtype:
    """Index dtype of the law's output: int32, or int64 when n >= 2^31."""
    return torch.int64 if is_wide(n) else torch.int32


def mix32(x):
    """murmur3 fmix32 finalizer — the spec's only hash primitive.

    ``x`` is a Python int or an int64 tensor holding uint32 values."""
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _M32
    x = x ^ (x >> 16)
    return x


# ---------------------------------------------------------------------------
# Key schedule
# ---------------------------------------------------------------------------

def fold_seed(seed) -> tuple:
    """Normalize a seed into the spec's (lo, hi) uint32 pair (SPEC.md §1).

    Accepts ints of any size (hi/lo split; negatives wrap two's-complement),
    an existing (lo, hi) pair (validated: length 2, integer halves in uint32
    range), or a uint32 0-d tensor (hi = 0).
    """
    if _is_int(seed):
        s = int(seed)
        return (s & _M32, (s >> 32) & _M32)
    if isinstance(seed, tuple):
        if len(seed) != 2:
            raise ValueError(
                f"seed tuple must be (lo, hi), got length {len(seed)}"
            )
        for name, half in zip(("lo", "hi"), seed):
            if _is_int(half) and not 0 <= int(half) <= _M32:
                raise ValueError(
                    f"seed tuple {name}={int(half)} outside uint32 range "
                    f"[0, 2**32) — fold a wide seed by passing the int "
                    f"itself, not a hand-split pair"
                )
        return seed
    return (seed, 0)


def as_u32_scalar(v):
    """uint32 scalar from an int (any value, wrapped) or a 0-d tensor."""
    if _is_int(v):
        return int(v) & _M32
    return v.to(torch.int64) & _M32


def u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as the int32 tensor of their bits."""
    return torch.where(x > INT32_MAX, x - (1 << 32), x).to(torch.int32)


def seed_triple(seed, epoch) -> tuple:
    """``(seed_lo, seed_hi, epoch)`` as Python ints in uint32 range: the
    layout of the seed triple that the kernels and the seed agreement of
    ``parallel/`` carry."""
    lo, hi = fold_seed(seed)
    return int(lo), int(hi), int(epoch) & _M32


def triple_seed_epoch(triple):
    """``(seed, epoch)`` arguments of the law from a seed triple tensor
    (three elements holding the uint32 bits, as int32 or int64): 0-d
    tensor views on the triple's device, so the keys derive from it with
    tensor ops and nothing is read back to the host."""
    return (triple[0], triple[1]), triple[2]


def derive_epoch_key(seed, epoch):
    """Fold ``(seed, epoch)`` into the epoch master key (uint32).

    With int arguments the key is a Python int, computed on the host; with
    0-d tensors (``triple_seed_epoch``) it is a 0-d int64 tensor on their
    device."""
    lo, hi = fold_seed(seed)
    seed_lo, seed_hi, ep = (as_u32_scalar(v) for v in (lo, hi, epoch))
    k = mix32(seed_lo ^ _GOLDEN)
    k = mix32(k ^ mix32(seed_hi ^ _C_SEED_HI))
    k = mix32(k ^ mix32(ep ^ _C_EPOCH))
    return k


def outer_key(epoch_key):
    return mix32(epoch_key ^ _C_OUTER)


def tail_key(epoch_key):
    return mix32(epoch_key ^ _C_TAIL)


def inner_key(epoch_key, window_id):
    """Per-source-window key for the intra-window bijection (vectorised)."""
    return mix32(mix32(window_id ^ _C_WIN) ^ _C_INNER ^ epoch_key)


def inner_pair_key(epoch_key):
    """Scalar pairing key shared by all windows' inner bijections."""
    return mix32(epoch_key ^ _C_PAIR)


def round_keys(pair_key, m: int, rounds: int) -> list:
    """The pairing constants ``K_r = mix32(pair_key ^ r*GOLDEN) mod m``.

    They depend on scalars only; the CUDA kernels compute the same list
    once per block into shared memory."""
    return [mix32(pair_key ^ ((r * _GOLDEN) & _M32)) % m for r in range(rounds)]


# ---------------------------------------------------------------------------
# Swap-or-not keyed bijection on [0, m)
# ---------------------------------------------------------------------------

def swap_or_not(x: torch.Tensor, m: int, key, rounds: int, pair_key=None):
    """Keyed bijection on ``[0, m)`` for arbitrary ``m`` (1 <= m < 2^31).

    ``x``: int64 tensor of values in ``[0, m)``.  ``key`` (scalar, or a
    tensor broadcastable against ``x``) drives the swap decision bits;
    ``pair_key`` (scalar; defaults to ``key``) drives the round pairing
    constants.  Per round ``r``: partner ``x' = (K_r - x) mod m``, the pair
    is canonical under ``max``, and a keyed bit of the canonical member
    decides whether the pair swaps.
    """
    if m <= 1:
        return x
    if pair_key is None:
        pair_key = key
    key2 = mix32(key ^ _C_BIT)
    for r, k_r in enumerate(round_keys(pair_key, m, rounds)):
        partner = (k_r + ((m - x) & _M32)) & _M32
        partner = torch.where(partner >= m, partner - m, partner)
        c = torch.where(x > partner, x, partner)
        b = mix32(c ^ key2 ^ ((r * _RC_BIT) & _M32))
        x = torch.where((b & 1) == 1, partner, x)
    return x


# ---------------------------------------------------------------------------
# Windowed permutation pi over [0, n)
# ---------------------------------------------------------------------------

def check_index_space(n: int, window: int) -> None:
    """What the law refuses: the window and the window count are uint32
    bijection domains and must stay below 2^31."""
    if window <= 0:
        raise ValueError(f"window must be >= 1, got {window}")
    if window > INT32_MAX:
        raise ValueError("window must be < 2^31")
    if n // window > INT32_MAX:
        raise ValueError(
            f"n // window must be < 2^31 (n={n}, window={window})"
        )


def windowed_perm(
    p: torch.Tensor,
    n: int,
    window: int,
    epoch_key,
    *,
    order_windows: bool = True,
    rounds: int = DEFAULT_ROUNDS,
    pair_epoch_key=None,
) -> torch.Tensor:
    """Map output positions ``p`` (int64, values in [0, n)) to dataset
    indices (int64).

    ``pair_epoch_key`` (default: ``epoch_key``) feeds the swap-or-not
    pairing schedules; ``epoch_key`` feeds the decision bits.
    """
    ek_pair = epoch_key if pair_epoch_key is None else pair_epoch_key
    W = int(window)
    check_index_space(n, W)
    nw_full = n // W
    body_len = nw_full * W
    tail_len = n - body_len

    # --- body lanes -------------------------------------------------------
    if nw_full > 0:
        # clip tail lanes into domain; masked out at the end
        j = torch.clamp(p // W, max=nw_full - 1)
        r0 = p % W
        if order_windows and nw_full > 1:
            k = swap_or_not(j, nw_full, outer_key(epoch_key), rounds,
                            pair_key=outer_key(ek_pair))
        else:
            k = j
        kin = inner_key(epoch_key, k)
        rho = swap_or_not(r0, W, kin, rounds, pair_key=inner_pair_key(ek_pair))
        body_idx = k * W + rho
    else:
        body_idx = p  # no full windows; every lane is tail
    # --- tail lanes -------------------------------------------------------
    if tail_len > 0:
        tpos = torch.where(p >= body_len, p - body_len, torch.zeros_like(p))
        tpos = torch.clamp(tpos, max=tail_len - 1)
        rho_t = swap_or_not(tpos, tail_len, tail_key(epoch_key), rounds,
                            pair_key=tail_key(ek_pair))
        tail_idx = body_len + rho_t
        if nw_full > 0:
            return torch.where(p < body_len, body_idx, tail_idx)
        return tail_idx
    return body_idx


# ---------------------------------------------------------------------------
# Length / padding math  (contract of torch distributed.py:92-105)
# ---------------------------------------------------------------------------

def shard_sizes(n: int, world: int, drop_last: bool) -> tuple[int, int]:
    """Return ``(num_samples, total_size)``: ``drop_last`` floors to a
    world-divisible total (dropping the tail); otherwise ceil + wrap-padding.
    """
    if n <= 0:
        raise ValueError(f"dataset size must be >= 1, got {n}")
    if world <= 0:
        raise ValueError(f"world must be >= 1, got {world}")
    if drop_last:
        if n < world:
            raise ValueError(
                f"drop_last=True requires n >= world (n={n}, world={world})"
            )
        num_samples = n // world
    else:
        num_samples = math.ceil(n / world)
    return num_samples, num_samples * world


def wrap_pos(x, wide: bool):
    """uint32 wrap of position arithmetic (uint64 positions never wrap)."""
    return x if wide else x & _M32


_M63 = (1 << 63) - 1


def u64_divmod(x: torch.Tensor, d):
    """``(x // d, x % d)`` of the uint64 values whose int64 bits are ``x``
    (a negative ``x`` stands for ``x + 2^64``), for divisors ``1 <= d <=
    2^63 - 1`` (an int or an int64 tensor broadcastable against ``x``).
    The quotient comes as int64 bits, modulo 2^64.

    ``x & (2^63 - 1)`` is ``x`` or ``x + 2^63``; with ``2^63 = c*d + e``,
    ``e`` in ``[1, d]``, the high half adds ``c`` to the quotient and ``e``
    to the remainder ``r < d``.  The sum ``r + e`` may pass 2^63 when
    ``d > 2^62``, so the carry is taken as ``r >= d - e`` and the
    remainder as ``r - (d - e)`` or ``r + e``, each below ``d``."""
    a = x & _M63
    q, r = a // d, a % d
    c, e = _M63 // d, _M63 % d + 1
    gap = d - e
    carry = r >= gap
    neg = x < 0
    return (torch.where(neg, q + c + carry.to(torch.int64), q),
            torch.where(neg, torch.where(carry, r - gap, r + e), r))


def rank_positions(n: int, rank, world: int, num_samples: int,
                   partition: str, wide: bool, device=None) -> torch.Tensor:
    """Global stream positions owned by ``rank``, wrapped mod n (int64).

    strided: ``rank, rank+world, ...``; blocked:
    ``rank*num_samples + [0, num_samples)``.  ``wide`` selects uint64
    position semantics; otherwise the arithmetic wraps as uint32 before
    the ``mod n``, as the law's uint32 position math does.
    """
    ar = torch.arange(num_samples, dtype=torch.int64, device=device)
    rank_p = wrap_pos(rank, wide)
    if partition == "strided":
        p = wrap_pos(rank_p + wrap_pos(world * ar, wide), wide)
    elif partition == "blocked":
        p = wrap_pos(wrap_pos(rank_p * num_samples, wide) + ar, wide)
    else:
        raise ValueError(
            f"partition must be 'strided' or 'blocked', got {partition!r}"
        )
    return p % n


def remaining_stream_positions(q: torch.Tensor, old_world: int,
                               old_num_samples: int, consumed: int,
                               partition: str, wide: bool) -> torch.Tensor:
    """Elastic-resharding position map (SPEC.md §6): remainder ordinals
    ``q`` to the un-consumed global stream positions, ascending.

      strided:  ``pos(q) = consumed*old_world + q``.
      blocked:  ``pos(q) = (q // gap)*ns + consumed + q % gap``.
    """
    if consumed >= old_num_samples:
        raise ValueError(
            f"epoch fully consumed (consumed={consumed} >= "
            f"num_samples={old_num_samples}); the remainder is empty"
        )
    q = wrap_pos(q.to(torch.int64), wide)
    if partition == "strided":
        return wrap_pos(wrap_pos(consumed * old_world, wide) + q, wide)
    if partition == "blocked":
        gap = old_num_samples - consumed
        return wrap_pos(
            wrap_pos((q // gap) * old_num_samples, wide) + consumed + q % gap,
            wide,
        )
    raise ValueError(
        f"partition must be 'strided' or 'blocked', got {partition!r}"
    )


def compose_remainder_chain(q: torch.Tensor, chain, partition: str,
                            wide: bool) -> torch.Tensor:
    """Map ordinals of the innermost remainder domain through a cascade of
    elastic reshard layers to base-epoch stream positions (SPEC.md §6).

    ``chain`` holds ``(world, num_samples, consumed)`` triples, outermost
    first; between layers the mapped ordinal wraps mod the receiving
    layer's remaining count.
    """
    q = wrap_pos(q.to(torch.int64), wide)
    for i in range(len(chain) - 1, 0, -1):
        world, ns, consumed = chain[i]
        q = remaining_stream_positions(q, world, ns, consumed, partition, wide)
        w_prev, ns_prev, c_prev = chain[i - 1]
        q = q % ((ns_prev - c_prev) * w_prev)
    world, ns, consumed = chain[0]
    return remaining_stream_positions(q, world, ns, consumed, partition, wide)


def elastic_chain(n: int, layers, new_world: int, drop_last: bool = False):
    """Validate a reshard cascade and size the current remainder
    (SPEC.md §6/§6.1).

    ``layers`` is ``[(world, consumed), ...]`` outermost first.  Returns
    ``(chain, remaining, num_samples)``: the ``(world, ns, consumed)``
    triples ``compose_remainder_chain`` consumes (``ns`` recomputed, never
    trusted from a checkpoint), the innermost remainder count and the
    per-rank length at ``new_world``.  Pure.
    """
    layers = list(layers)
    if not layers:
        raise ValueError(
            "reshard cascade is empty: layers must hold at least the base "
            "epoch's (world, consumed) pair"
        )
    chain = []
    domain = None  # None = the base epoch; else the remaining count
    for world, consumed in layers:
        world, consumed = int(world), int(consumed)
        if domain is None:
            ns, _ = shard_sizes(n, world, drop_last)
        else:
            if world < 1:
                raise ValueError(f"world must be >= 1, got {world}")
            if drop_last:
                ns = domain // world
            else:
                ns = -(-domain // world) if domain else 0
        if not 0 <= consumed <= ns:
            raise ValueError(
                f"consumed {consumed} outside [0, {ns}] for "
                f"world={world} in reshard layer {len(chain)}"
            )
        chain.append((world, ns, consumed))
        domain = (ns - consumed) * world
    if int(new_world) < 1:
        raise ValueError(f"world must be >= 1, got {new_world}")
    if drop_last:
        num_samples = domain // int(new_world)
    else:
        num_samples = -(-domain // int(new_world)) if domain else 0
    return tuple(chain), int(domain), int(num_samples)


def stream_indices_at_generic(
    positions: torch.Tensor,
    n: int,
    window: int,
    seed,
    epoch,
    *,
    shuffle: bool = True,
    order_windows: bool = True,
    rounds: int = DEFAULT_ROUNDS,
) -> torch.Tensor:
    """Random access into the epoch stream: ``stream(p) = pi(p mod n)``
    (SPEC.md §4), on the device of ``positions``: int64 positions taken
    as uint32 (n < 2^31) or uint64, as the reference casts them, then mod
    n."""
    p = torch.as_tensor(positions).to(torch.int64)
    p = u64_divmod(p, n)[1] if is_wide(n) else (p & _M32) % n
    if shuffle:
        ek = derive_epoch_key(seed, epoch)
        p = windowed_perm(p, n, window, ek, order_windows=order_windows,
                          rounds=rounds)
    return p.to(out_dtype(n))


def epoch_indices_generic(
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
    rounds: int = DEFAULT_ROUNDS,
    device=None,
) -> torch.Tensor:
    """Rank's epoch indices: int32[num_samples] (int64 when n >= 2^31) on
    ``device``.  Deterministic in ``(n, window, seed, epoch, rank, world,
    flags)``."""
    num_samples, _total = shard_sizes(n, world, drop_last)
    p = rank_positions(n, rank, world, num_samples, partition, is_wide(n),
                       device)
    if shuffle:
        ek = derive_epoch_key(seed, epoch)
        p = windowed_perm(p, n, window, ek, order_windows=order_windows,
                          rounds=rounds)
    return p.to(out_dtype(n))


def elastic_indices_generic(n, window, seed, epoch, rank, world, num_samples,
                            chain, *, shuffle, order_windows, partition,
                            rounds, device):
    """The remainder law on ``device``: rank positions over the innermost
    remainder, composed through the reshard chain, then the epoch stream."""
    wide = is_wide(n)
    w_last, ns_last, c_last = chain[-1]
    q = rank_positions(
        (ns_last - c_last) * w_last, rank, world, num_samples, partition,
        wide, device,
    )
    pos = compose_remainder_chain(q, chain, partition, wide)
    return stream_indices_at_generic(
        pos, n, window, seed, epoch, shuffle=shuffle,
        order_windows=order_windows, rounds=rounds,
    )
