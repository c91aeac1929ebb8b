"""The mixture-of-sources law of SPEC.md §8, in plain torch.

A frozen copy written from the specification, vectorised over lanes, over
the §1-§3 law of ``reference/law.py`` (its ``mix32``, ``epoch_key`` and
``swap_or_not``), and independent of the program under test: it imports
nothing of it.  §8.1's quotas by largest remainder, §8.2's smooth
round-robin pattern and its prefix counts, §8.2a's per-block rotation
(pattern version 2, shuffled), §8.3's draw ``j`` of the lane's source, its
pass and in-pass offset, the source's seed and pass-folded epoch, and its
§3 permutation with the decision keys from ``(seed_s, epoch_u)`` and the
pairing keys from the pass-free ``(seed_s, epoch)``; §8.4's strided or
blocked rank positions over the total stream (never wrapped).  Every
value is a uint32 held in an int64 tensor, as in ``reference/law.py``.
"""

from __future__ import annotations

import torch

from bench_port.reference.law import M32, epoch_key, mix32, swap_or_not

SEED_STRIDE = 0xB5297A4D2C7E9FD3  # §8.3's per-source seed offset
C_PASS = 0x632BE5AB  # §8.3's pass fold
C_ROT = 0x6A09E667  # §8.2a's rotation key


def quotas(weights, block: int) -> list:
    """§8.1: slots a block per source, by largest remainder."""
    total = sum(weights)
    k = [v * block // total for v in weights]
    rem = [(v * block) % total for v in weights]
    for s in sorted(range(len(k)), key=lambda s: (-rem[s], s))[:block
                                                                - sum(k)]:
        k[s] += 1
    if min(k) < 1:
        raise ValueError(f"a source gets no slot of a {block}-slot block")
    return k


def pattern(k, block: int) -> tuple:
    """§8.2: the smooth round-robin ``pattern[t]`` and the prefix counts
    ``prefix[t, s] = |{t' < t: pattern[t'] = s}|`` as int64 tensors."""
    err, seen = [0] * len(k), [0] * len(k)
    pat, prefix = [], []
    for _ in range(block):
        prefix.append(list(seen))
        s = max(range(len(k)), key=lambda i: (err[i] + k[i], -i))
        pat.append(s)
        err = [e + q for e, q in zip(err, k)]
        err[s] -= block
        seen[s] += 1
    return torch.tensor(pat), torch.tensor(prefix)


def _split_permute(u, n, w, ek, ek0, rounds: int):
    """§3's ``pi(u)`` over ``[0, n)`` at window ``w`` (per-lane tensors),
    with §8.3's split keys: the decision keys from ``ek`` (per lane), the
    pairing keys from the pass-free ``ek0``."""
    nw = n // w
    body = nw * w
    in_body = u < body
    j = torch.minimum(u // w, nw - 1)
    outer, outer0 = mix32(ek ^ 0xA5A5A5A5), mix32(ek0 ^ 0xA5A5A5A5)
    k = swap_or_not(j, nw, outer, outer0, rounds)
    inner = mix32(ek ^ 0x5A5A5A5A ^ mix32(k ^ 0x27D4EB2F))
    v_body = k * w + swap_or_not(u % w, w, inner, mix32(ek0 ^ 0x165667B1),
                                 rounds)
    tail = n - body
    tail_1 = torch.clamp(tail, min=1)
    t = torch.clamp(u - body, min=0) % tail_1
    v_tail = body + swap_or_not(t, tail_1, mix32(ek ^ 0x3C3C3C3C),
                                mix32(ek0 ^ 0x3C3C3C3C), rounds)
    return torch.where(in_body, v_body, v_tail)


def tables(sources, weights, windows, block: int, device) -> dict:
    """The law's per-source tensors: quotas ``k``, the pattern and prefix
    counts, sizes ``n``, windows ``w`` (capped at the size) and bases."""
    k = quotas(weights, block)
    pat, prefix = (t.to(device) for t in pattern(k, block))
    windows = ([windows] * len(sources) if isinstance(windows, int)
               else windows)
    n = torch.tensor(sources, device=device)
    return dict(k=torch.tensor(k, device=device), pattern=pat, prefix=prefix,
                n=n, w=torch.minimum(torch.tensor(windows, device=device), n),
                base=torch.cumsum(n, 0) - n)


def draws(p: torch.Tensor, tab: dict, block: int, seed: int,
          epoch: int) -> tuple:
    """§8.2a-§8.3: each position's source ``s``, its pass and its in-pass
    offset ``u``."""
    seed = int(seed)
    rk = mix32(epoch_key(seed & M32, (seed >> 32) & M32, epoch) ^ C_ROT)
    blk, t = p // block, p % block
    rot = mix32(rk ^ (blk & M32)) % block
    slot = (t + rot) % block
    s = tab["pattern"][slot]
    k_s = tab["k"][s]
    wrap = torch.where(t + rot >= block, k_s, 0)
    j = blk * k_s + tab["prefix"][slot, s] + wrap - tab["prefix"][rot, s]
    n = tab["n"][s]
    return s, j // n, j % n


def stream_at(p: torch.Tensor, sources, weights, windows, block: int,
              seed: int, epoch: int, rounds: int = 24) -> torch.Tensor:
    """§8.3: the global ids of mixture positions ``p`` (int64, shuffled,
    pattern version 2)."""
    dev = p.device
    tab = tables(sources, weights, windows, block, dev)
    s, pas, u = draws(p, tab, block, seed, epoch)
    seed = int(seed)
    src_seed = [seed ^ (SEED_STRIDE + i) for i in range(len(sources))]
    lo = torch.tensor([x & M32 for x in src_seed], device=dev)[s]
    hi = torch.tensor([(x >> 32) & M32 for x in src_seed], device=dev)[s]
    ep_u = mix32((epoch & M32) ^ mix32((pas & M32) ^ C_PASS))
    ek = epoch_key(lo, hi, ep_u)
    ek0 = epoch_key(lo, hi, epoch)
    return tab["base"][s] + _split_permute(u, tab["n"][s], tab["w"][s], ek,
                                           ek0, rounds)


def rank_positions(total: int, rank: int, world: int, lo: int, hi: int,
                   partition: str, device) -> torch.Tensor:
    """§8.4: the mixture positions of a rank's lanes ``[lo, hi)``."""
    t = torch.arange(lo, hi, device=device)
    ns = -(-total // world)
    return rank + world * t if partition == "strided" else rank * ns + t


def epoch_indices(sources, weights, windows, block: int, seed: int,
                  epoch: int, rank: int, world: int, *, rounds: int = 24,
                  partition: str = "strided", device="cpu",
                  chunk: int = 1 << 22) -> torch.Tensor:
    """§8.4: rank ``rank``'s mixture epoch (T = the sources' total) as
    int64, in chunks of ``chunk`` lanes."""
    total = sum(sources)
    ns = -(-total // world)
    out = torch.empty(ns, dtype=torch.int64, device=device)
    for lo in range(0, ns, chunk):
        hi = min(ns, lo + chunk)
        pos = rank_positions(total, rank, world, lo, hi, partition, device)
        out[lo:hi] = stream_at(pos, sources, weights, windows, block, seed,
                               epoch, rounds)
    return out
