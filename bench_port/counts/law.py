"""The work of the law, counted from its definition (SPEC.md) and the data,
for a kernel's roofline share: int32 operations and bytes of one regen.

The constants are those the repository's chip smoke stated for each kernel
family (``chip_smoke.py``, counted with the fusions the ISA offers and
without the two multiplies of mix32, which may issue on the FMA pipe).
They price what the law asks of any implementation: a lane's bijection
rounds, its keys, its position arithmetic, each input byte read once and
each output byte written once.  An intermediate table that one design
keeps between two kernels is not counted, so a redesign that drops it
reads the same work.
"""

from __future__ import annotations

import numpy as np

#: per swap-or-not round: partner (1) + wrap (2) + max (1) + key xor (1)
#: + mix32 shifts/xors (6) + decision bit and select (2)
ROUND_OPS = 13
#: per-element decision key of a per-window bijection: inner_key (two
#: mix32 + xors, 14) + key2 (mix32 + xor, 7)
INNER_KEY_OPS = 21
#: position and index arithmetic per element (div, mod, mod n)
POS_OPS = 3
#: a shard-stream lane besides its bijection: its row (t / m as a
#: multiply-high, its subtract, add and two shifts: 5, minus the first
#: row: 1), u (2), W and the body and window tests (3), the combine (1)
#: and the offset add (1)
SHARD_LANE_OPS = 13
#: a window of w < m: u / w as a multiply-high (5), the window base and
#: in-window offset (2), the key index (1)
WINDOW_LANE_OPS = 8
#: the tail bijection's key2 (mix32 + xor)
TAIL_KEY_OPS = 7
#: per shard row: the carried fold (4), seed key (three mix32, three
#: xors: 21), epoch key (two mix32, two xors: 14), pairing and tail keys
#: (14), W and body (4); per pairing constant mix32, xor, multiply,
#: compare, mod and select (11), two schedules of ``rounds``
ROW_BASE_OPS, ROW_KEY_OPS = 57, 11


def body_lanes(n: int, window: int, world: int, rank: int, first: int = 0,
               partition: str = "strided") -> tuple:
    """``(body, tail)``: the rank's lanes ``t >= first`` whose position
    lies in a full window (two bijections) or in the tail window (one)."""
    ns = -(-n // world)
    t = np.arange(first, ns, dtype=np.int64)
    p = (rank + world * t if partition == "strided" else rank * ns + t) % n
    body = int((p < (n // window) * window).sum())
    return body, ns - first - body


def index_amortized(n: int, window: int, world: int, rank: int,
                    rounds: int = 24) -> tuple:
    """``(ops, bytes)`` of one rank's amortized regen (strided, shuffled,
    ``window % world == 0``, n < 2^31): the window order's ``nw`` outer
    bijections once, one inner bijection per lane of the rank's whole
    windows, the full law on the rest; int32 lanes written."""
    son = rounds * ROUND_OPS
    ns = -(-n // world)
    nw = n // window
    body = nw * (window // world)
    rest_body, rest_tail = body_lanes(n, window, world, rank, first=body)
    ops = (body * (son + INNER_KEY_OPS + POS_OPS)
           + rest_body * (2 * son + INNER_KEY_OPS + POS_OPS)
           + rest_tail * (son + POS_OPS) + nw * son)
    return ops, ns * 4


def shard_expansion(row_sizes: np.ndarray, within_shard_shuffle=True,
                    rounds: int = 24, out_bytes: int = 4) -> tuple:
    """``(ops, bytes)`` of the §7.2 expansion of one rank's shard stream
    whose rows hold ``row_sizes`` samples: each row's keys and pairing
    schedules, each lane's row, offset and bijection; each row's id (4)
    and size and offset (8) read, each lane written."""
    m = np.asarray(row_sizes, dtype=np.int64)
    rows, lanes = m.size, int(m.sum())
    son = rounds * ROUND_OPS
    b = within_shard_shuffle
    if b is True:
        w = m
    elif b is False or int(b) < 2:  # sequential: no key, no bijection
        return lanes * SHARD_LANE_OPS, rows * 12 + lanes * out_bytes
    else:
        w = np.minimum(int(b), m)
    shuffled = w > 1
    body = np.where(shuffled, m // np.maximum(w, 1) * w, 0)
    tail = np.where(shuffled, m - body, 0)
    stored = int(m[~shuffled].sum())
    windowed = shuffled & (w < m)
    n_windows = int((m // np.maximum(w, 1))[windowed].sum())
    ops = ((int(body.sum()) + int(tail.sum())) * (SHARD_LANE_OPS + son)
           + stored * SHARD_LANE_OPS
           + int(body[windowed].sum()) * WINDOW_LANE_OPS
           + n_windows * INNER_KEY_OPS
           + rows * (INNER_KEY_OPS + TAIL_KEY_OPS)
           + rows * (ROW_BASE_OPS + 2 * rounds * ROW_KEY_OPS))
    return ops, rows * 12 + lanes * out_bytes
