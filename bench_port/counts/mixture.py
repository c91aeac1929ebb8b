"""The work of the §8 mixture law (SPEC.md), counted per lane from its
definition and the data, for ``mixture_fused``'s roofline share: int32
operations and bytes of one rank's regen.

The per-lane constants are those the repository's chip smoke stated for the
mixture kernel (``chip_smoke.py``, counted as ``counts/law.py``'s are);
the bijection's rounds and the inner key are ``counts/law.py``'s.  A lane
whose in-pass offset lies in its source's full windows runs the outer and
the inner bijection, a lane in the source's tail window one.  The sources'
keys (the keys buffer's words) are derived once a regen: a design that
derives them again in every block does more than the law asks, and that
is not counted.
"""

from __future__ import annotations

import torch

from bench_port.counts.law import INNER_KEY_OPS, ROUND_OPS
from bench_port.reference import mixture_law

#: a lane besides its bijections: the position (1), block and slot (2),
#: the v2 rotation (11), the prefix count (5), j, pass and offset (3), the
#: pass-folded decision key (28), the body/tail test, window and in-window
#: offset (3), the combine and the base (2)
MIX_LANE_OPS = 55
#: the outer or tail bijection's keys: its decision key (7) and key2 (7)
BIJ_KEY_OPS = 14
#: a word of the sources' keys: the source's seed key, its pass-free
#: epoch key, the pairing key and K_r
KEY_WORD_OPS = 51


def key_words(num_sources: int, rounds: int) -> int:
    """The keys' words: the rotation key, the epoch, and per source its
    seed key and ``3 * rounds`` pairing constants."""
    return 2 + num_sources * (1 + 3 * rounds)


def table_bytes(num_sources: int, block: int) -> int:
    """The law's static tables, each read once: the pattern and the prefix
    counts (int32 a slot, a slot and source) and 8 words a source."""
    return 4 * (block * (1 + num_sources) + 8 * num_sources)


def mixture_fused(body: int, tail: int, num_sources: int, block: int,
                  rounds: int = 24, out_bytes: int = 4) -> tuple:
    """``(ops, bytes)`` of a regen of ``body`` lanes in full windows and
    ``tail`` in tail windows: the lanes' work, the keys derived once, the
    tables read once and every lane's id written."""
    son = rounds * ROUND_OPS
    ops = (body * (MIX_LANE_OPS + BIJ_KEY_OPS + INNER_KEY_OPS + 2 * son)
           + tail * (MIX_LANE_OPS + BIJ_KEY_OPS + son)
           + key_words(num_sources, rounds) * KEY_WORD_OPS)
    return ops, (body + tail) * out_bytes + table_bytes(num_sources, block)


def rank_lanes(sources, weights, windows, block: int, seed: int, epoch: int,
               rank: int, world: int, partition: str = "strided",
               device="cpu", chunk: int = 1 << 22) -> tuple:
    """``(body, tail)``: the rank's lanes in an epoch whose offset lies in
    its source's full windows, and in its tail window, by the plain law's
    draws."""
    total = sum(sources)
    ns = -(-total // world)
    tab = mixture_law.tables(sources, weights, windows, block, device)
    tail = 0
    for lo in range(0, ns, chunk):
        hi = min(ns, lo + chunk)
        p = mixture_law.rank_positions(total, rank, world, lo, hi, partition,
                                       device)
        s, _, u = mixture_law.draws(p, tab, block, seed, epoch)
        tail += int((u >= tab["n"][s] // tab["w"][s] * tab["w"][s]).sum())
    return ns - tail, tail
