"""The partial-shuffle law of SPEC.md §1-§4 and §7.2, in plain torch.

A frozen copy written from the specification, vectorised over lanes and
independent of the program under test: it imports nothing of it.  Every
value is a uint32 (or a position below 2^63) held in an int64 tensor; a
product of two uint32 words wraps in int64, and the mask keeps its low 32
bits, which two's complement leaves exact.  Runs on any device.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
GOLDEN64 = 0x9E3779B97F4A7C15  # SPEC.md §7.1's per-shard seed stride


def mix32(x):
    """murmur3's fmix32 on a uint32 (an int, or an int64 tensor)."""
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & M32
    return x ^ (x >> 16)


def epoch_key(lo, hi, epoch):
    """§1: the epoch master key of the folded seed ``(lo, hi)``."""
    k = mix32(lo ^ 0x9E3779B9)
    k = mix32(k ^ mix32(hi ^ 0x85EBCA6B))
    return mix32(k ^ mix32((epoch & M32) ^ 0xC2B2AE35))


def seed_key(seed: int, epoch: int) -> int:
    seed = int(seed)
    return epoch_key(seed & M32, (seed >> 32) & M32, int(epoch))


def swap_or_not(x, m, key, pair_key, rounds: int):
    """§2: ``SoN(x; m, key, pair_key, R)``.  ``m``, ``key`` and
    ``pair_key`` may be scalars or tensors shaped like ``x`` (one
    permutation per lane group); ``m == 1`` is the identity by the same
    arithmetic."""
    key2 = mix32(key ^ 0x94D049BB)
    for r in range(rounds):
        k_r = mix32(pair_key ^ ((r * 0x9E3779B9) & M32)) % m
        partner = (k_r - x) % m
        c = torch.maximum(x, partner)
        b = mix32(c ^ key2 ^ ((r * 0x7FEB352D) & M32)) & 1
        x = torch.where(b == 1, partner, x)
    return x


def permute(p, n, window, ek, *, order_windows: bool, rounds: int):
    """§3: ``pi(p)`` for positions ``p`` in ``[0, n)``.  ``n``, ``window``
    and ``ek`` are ints, or tensors shaped like ``p`` (a permutation per
    lane group, as §7.2 expands shards)."""
    nw = n // window
    body = nw * window
    outer = mix32(ek ^ 0xA5A5A5A5)
    tail_key = mix32(ek ^ 0x3C3C3C3C)
    pair = mix32(ek ^ 0x165667B1)
    in_body = p < body
    # lanes of the other class are computed on a valid stand-in and dropped
    nw_1 = torch.clamp(torch.as_tensor(nw, device=p.device), min=1)
    j = torch.minimum(p // window, nw_1 - 1)
    k = swap_or_not(j, nw_1, outer, outer, rounds) if order_windows else j
    inner = mix32(ek ^ 0x5A5A5A5A ^ mix32(k ^ 0x27D4EB2F))
    v_body = k * window + swap_or_not(p % window, window, inner, pair, rounds)
    tail = n - body
    tail_1 = torch.clamp(torch.as_tensor(tail, device=p.device), min=1)
    u = torch.clamp(p - body, min=0) % tail_1
    v_tail = body + swap_or_not(u, tail_1, tail_key, tail_key, rounds)
    return torch.where(in_body, v_body, v_tail)


def num_samples(n: int, world: int, drop_last: bool = False) -> int:
    """§4: the samples of each rank."""
    return n // world if drop_last else -(-n // world)


def epoch_indices(n: int, window: int, seed: int, epoch: int, rank: int,
                  world: int, *, rounds: int = 24, partition="strided",
                  order_windows: bool = True, device="cpu",
                  chunk: int = 1 << 24) -> torch.Tensor:
    """§4: rank ``rank``'s epoch stream as int64, computed in chunks of
    ``chunk`` lanes so that a large rank share fits beside the program."""
    ns = num_samples(n, world)
    ek = seed_key(seed, epoch)
    out = torch.empty(ns, dtype=torch.int64, device=device)
    for lo in range(0, ns, chunk):
        t = torch.arange(lo, min(ns, lo + chunk), device=device)
        pos = rank + world * t if partition == "strided" else rank * ns + t
        out[lo:lo + t.numel()] = permute(pos % n, n, window, ek,
                                         order_windows=order_windows,
                                         rounds=rounds)
    return out


def shard_keys(seed: int, sids: torch.Tensor, epoch: int):
    """§7.1: the epoch key of each shard's seed
    ``seed XOR (0x9E3779B97F4A7C15 + sid)``, folded to its 32-bit halves
    without leaving int64."""
    seed = int(seed)
    s_lo, s_hi = seed & M32, (seed >> 32) & M32
    low = (GOLDEN64 & M32) + sids
    lo = (low & M32) ^ s_lo
    hi = (((GOLDEN64 >> 32) + (low >> 32)) & M32) ^ s_hi
    return epoch_key(lo, hi, int(epoch))


def expand_shards(sids: torch.Tensor, sizes: torch.Tensor, seed: int,
                  epoch: int, *, within_shard_shuffle=True,
                  rounds: int = 24) -> torch.Tensor:
    """§7.2: the global sample indices of the shard stream ``sids`` (int64,
    on their device) over shards of ``sizes`` samples (int64, same
    device), in stream order."""
    sids = sids.long()
    m = sizes[sids]
    offsets = torch.cumsum(sizes, 0) - sizes
    ends = torch.cumsum(m, 0)
    lanes = int(ends[-1]) if m.numel() else 0
    row = torch.repeat_interleave(torch.arange(m.numel(), device=m.device),
                                  m, output_size=lanes)
    u = torch.arange(lanes, device=m.device) - (ends - m)[row]
    mr = m[row]
    ek = shard_keys(seed, sids, epoch)[row]
    b = within_shard_shuffle
    if b is True or (not isinstance(b, bool) and int(b) >= 2):
        window = mr if b is True else torch.clamp(mr, max=int(b))
        local = permute(u, mr, torch.clamp(window, min=1), ek,
                        order_windows=False, rounds=rounds)
    else:
        local = u
    return offsets[sids][row] + local
