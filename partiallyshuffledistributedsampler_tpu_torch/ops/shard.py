"""Shard-index mode (SPEC.md §7): the within-shard law on tensors.

A rank's shard-id stream expands into global sample indices, shard by
shard in stream order: shard ``sid`` of size ``m`` contributes
``offset[sid] + order(u)`` for ``u`` in ``[0, m)``, where ``order`` is the
§3 permutation at ``n = m`` with the per-shard seed
``seed ^ (_SHARD_SEED_STRIDE + sid)``:

* ``within_shard_shuffle=True``: one bijection over ``[0, m)`` (window
  ``W = m``, window id 0);
* an int ``w``: windows of ``W = min(w, m)`` that stay in place
  (``order_windows=False``), plus the tail bijection over ``m - nw*W``;
* ``False`` / ``0`` / ``W <= 1``: storage order.

The evaluation here runs per output lane, as the CUDA kernels of
``csrc/shard_kernels.cu`` do, and is their plain version: one row record
per selected shard (``shard_row_keys_ref``), then every lane from its
row's record (``shard_expand_ref``).  Every lane is an int64 tensor
holding a uint32 value, masked as in ``ops/core.py``.

The per-shard size tables live on the device once per ``shard_sizes``
(``shard_tables``); a regen uploads only what is new: the rank's shard
ids, and where those came from the host, the prefix of their sizes.

A regen launches first and confirms after: it queues its launches with
the tables that the last regen over the same sizes object on its device
confirmed (``remembered_tables``, found in O(1) by the object's identity
and length), and only then compares their sizes with every one of the
caller's (``confirm_tables``), while the card computes.  When they differ
(the caller changed its sizes in place) the regen is a miss: it looks
the tables up (``shard_tables``), launches again with them and drops the
first output.  A sizes object with nothing remembered is looked up
first.  Every regen is confirmed against the exact sizes passed, so the
answer is the same lane for lane; a caller that changes its sizes in
place on every regen pays one wasted launch each time.
``table_checks`` counts the hits and misses.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..analysis.lockorder import new_lock
from . import core

#: SPEC.md §7 per-shard seed stride (the 64-bit golden ratio, as used by
#: splitmix64): shard ``sid`` draws its within-shard permutation from
#: ``seed XOR (_SHARD_SEED_STRIDE + sid)`` folded per SPEC.md §1.
_SHARD_SEED_STRIDE = 0x9E3779B97F4A7C15
#: words of a row record before its two pairing schedules: the epoch key,
#: the inner pairing key, the tail key and the body length
ROW_HEAD = 4


def shard_seed(seed: int, sid: int) -> int:
    """The spec'd per-shard seed (SPEC.md §7).  Pure; any change is a spec
    version bump — checkpointed shard streams depend on it."""
    return int(seed) ^ (_SHARD_SEED_STRIDE + int(sid))


def shuffle_mode(within_shard_shuffle) -> tuple:
    """``(full, w)`` of a ``within_shard_shuffle`` option: ``True`` (and
    only the bool ``True``) is the full in-shard shuffle; anything else is
    a window int, ``np.int64(9)`` included, with 0 meaning sequential.
    A negative window raises ``ValueError``."""
    if within_shard_shuffle is True:
        return True, 0
    w = int(within_shard_shuffle)
    if w < 0:
        raise ValueError(f"within_shard_shuffle must be bool or >= 0, got {w}")
    return False, w


def _shard_epoch_keys(sid: torch.Tensor, seed) -> tuple:
    """The §1 fold of ``shard_seed(seed, sid)`` for a shard-id tensor:
    ``(lo, hi)`` uint32 values in int64 tensors on ``sid``'s device.

    Folding commutes with XOR, so ``fold(seed ^ K)`` is ``(lo(seed) ^
    K_lo, hi(seed) ^ K_hi)`` with ``K = _SHARD_SEED_STRIDE + sid``; the
    64-bit add is carried in uint32 halves (``sum_lo < sid`` is the
    carry), as the kernel does."""
    lo0, hi0 = (core.as_u32_scalar(v) for v in core.fold_seed(seed))
    sid = sid.to(torch.int64)
    sum_lo = ((_SHARD_SEED_STRIDE & core._M32) + sid) & core._M32
    carry = (sum_lo < sid).to(torch.int64)
    hi = ((_SHARD_SEED_STRIDE >> 32) + carry) & core._M32
    return lo0 ^ sum_lo, hi0 ^ hi


def sequential(full: bool, w: int) -> bool:
    """Whether mode ``(full, w)`` leaves every shard in storage order (a
    window of at most one sample): then no row record is read."""
    return not full and w <= 1


def row_windows(m: torch.Tensor, full: bool, w: int) -> torch.Tensor:
    """W_row: the shard itself for the full shuffle, else ``min(w, m)``."""
    return m if full else torch.clamp(m, max=w)


def row_words(rounds: int) -> int:
    """Words of one row record."""
    return ROW_HEAD + 2 * int(rounds)


def _schedule(pair: torch.Tensor, m: torch.Tensor, rounds: int):
    """[R, rounds] pairing constants ``mix32(pair ^ r*GOLDEN) % m`` (0
    where ``m <= 1``)."""
    rg = (torch.arange(rounds, dtype=torch.int64, device=pair.device)
          * core._GOLDEN) & core._M32
    k = core.mix32(pair[:, None] ^ rg[None, :]) % m.clamp(min=1)[:, None]
    return torch.where(m[:, None] > 1, k, torch.zeros_like(k))


def shard_row_keys_ref(sids: torch.Tensor, sizes: torch.Tensor, seed, epoch,
                       *, full: bool, w: int,
                       rounds: int = core.DEFAULT_ROUNDS) -> tuple:
    """The row records of a shard stream by torch ops on ``sids``' device:
    int32 [R * row_words(rounds)] (the uint32 bits of ``ek, pair, tk,
    body, K_inner[rounds], K_tail[rounds]``), and each row's shard size
    (int64 [R])."""
    m = sizes[sids.long()]
    lo, hi = _shard_epoch_keys(sids, seed)
    ek = core.derive_epoch_key((lo, hi), epoch)
    pair, tk = core.inner_pair_key(ek), core.tail_key(ek)
    W = row_windows(m, full, w)
    body = torch.where(W > 1, m // W.clamp(min=1) * W, m)
    rows = torch.cat([ek[:, None], pair[:, None], tk[:, None], body[:, None],
                      _schedule(pair, W, rounds),
                      _schedule(tk, m - body, rounds)], dim=1)
    return core.u32_bits(rows.reshape(-1)), m


def _rowwise_swap(x, m, key, pair, rounds: int):
    """swap-or-not over ``[0, m)`` with a modulus, decision key and pairing
    key per lane (all broadcastable int64 tensors): the pairing constant
    ``K_r = mix32(pair ^ r*GOLDEN) % m`` is computed where it is used.
    Equal per lane to ``core.swap_or_not`` with that lane's ``(m, key,
    pair_key)``; lanes with ``m <= 1`` pass through (core's early
    return)."""
    key2 = core.mix32(key ^ core._C_BIT)
    m_ok = m > 1
    msafe = m.clamp(min=1)
    for r in range(rounds):
        k_r = core.mix32(pair ^ ((r * core._GOLDEN) & core._M32)) % msafe
        partner = k_r + (m - x)
        partner = torch.where(partner >= m, partner - m, partner)
        c = torch.where(x > partner, x, partner)
        b = core.mix32(c ^ key2 ^ ((r * core._RC_BIT) & core._M32))
        x = torch.where(((b & 1) == 1) & m_ok, partner, x)
    return x


def shard_expand_ref(rowtab: Optional[torch.Tensor], sids: torch.Tensor,
                     offsets: torch.Tensor, ends: Optional[torch.Tensor], *,
                     m_uniform: int, lanes: int, full: bool, w: int,
                     rounds: int = core.DEFAULT_ROUNDS,
                     out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Every output lane of the expansion from the row records, in stream
    order, on ``sids``' device: the lane's row (``t // m_uniform``, or the
    first row whose inclusive prefix ``ends`` passes ``t``), its offset
    ``u`` in the shard, the §7.2 law at ``u``, plus the shard's offset.
    The pairing constants are recomputed per lane from the pairing keys
    (``_rowwise_swap``), not read from the records.  In sequential mode
    (``sequential(full, w)``) the lane is ``u`` and ``rowtab`` may be
    None."""
    dev = sids.device
    t = torch.arange(lanes, dtype=torch.int64, device=dev)
    if ends is None:
        row = t // m_uniform
        m = torch.full_like(t, m_uniform)
        start = row * m_uniform
    else:
        row = torch.searchsorted(ends, t, right=True)
        start = torch.where(row > 0, ends[(row - 1).clamp(min=0)], 0)
        m = ends[row] - start
    u = t - start
    if sequential(full, w):
        return (offsets[sids.long()[row]] + u).to(out_dtype)
    tab = rowtab.view(-1, row_words(rounds)).long() & core._M32
    ek, pair, tk, body = (tab[row, c] for c in range(ROW_HEAD))
    W = row_windows(m, full, w)
    Wsafe = W.clamp(min=1)
    is_body = u < body
    win = torch.zeros_like(u) if full else u // Wsafe
    r0 = torch.where(is_body, u - win * W, 0)
    rho = _rowwise_swap(r0, W, core.inner_key(ek, win), pair, rounds)
    tail = m - body
    tpos = torch.where(is_body, 0, u - body)
    rho_t = _rowwise_swap(tpos, tail, tk, tk, rounds)
    idx = torch.where(is_body, win * W + rho, body + rho_t)
    idx = torch.where(W > 1, idx, u)
    return (offsets[sids.long()[row]] + idx).to(out_dtype)


class ShardTables:
    """One ``shard_sizes`` table on one device: the sizes and their
    exclusive prefix (each shard's first global index) as int64 tensors,
    and what the host needs to know of them."""

    def __init__(self, shard_sizes, device) -> None:
        # a copy: the cache compares it with the caller's sizes, which the
        # caller may change in place
        sizes = np.array(shard_sizes, dtype=np.int64).reshape(-1)
        if sizes.size and (sizes.min() < 0 or sizes.max() > core.INT32_MAX):
            raise ValueError(
                f"shard sizes must be in [0, 2^31), got range "
                f"[{sizes.min()}, {sizes.max()}]"
            )
        self.sizes = sizes
        offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
        self.num_shards = int(sizes.size)
        #: the whole shard space decides the index type, not the selection
        self.total_space = int(sizes.sum())
        self.out_dtype = core.out_dtype(self.total_space)
        #: every shard's size when they are all equal and nonzero, else None
        self.m_uniform = (int(sizes[0]) if sizes.size and sizes[0] > 0
                          and (sizes == sizes[0]).all() else None)
        self.device = torch.device(device)
        self.dev_sizes = torch.from_numpy(sizes).to(self.device)
        self.dev_offsets = torch.from_numpy(offsets).to(self.device)


_tables: dict = {}
_TABLES_CAP = 8

#: guards ``_confirmed`` and ``table_checks``: an index server regenerates
#: on several handler threads at once
_lock = new_lock("ops.shard")
#: the tables the last regen confirmed, by (device, id of the sizes
#: object, number of sizes), each held with that object so that its id is
#: no other object's while it is remembered
_confirmed: dict = {}
#: confirmations of a regen's remembered tables (reset with
#: ``reset_table_checks``): a hit when the lookup returned the tables the
#: regen launched with, a miss when it launched again
table_checks = {"hits": 0, "misses": 0}


def reset_table_checks() -> None:
    with _lock:
        for k in table_checks:
            table_checks[k] = 0


def _device(device) -> torch.device:
    """``device`` with a CUDA device's index made explicit."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _remember_key(shard_sizes, device) -> tuple:
    """Where the tables of this sizes object are remembered, read without
    a pass over the sizes."""
    count = (shard_sizes.size if isinstance(shard_sizes, np.ndarray)
             else len(shard_sizes))
    return (str(device), id(shard_sizes), count)


def shard_tables(shard_sizes, device) -> ShardTables:
    """The tables of ``shard_sizes`` on ``device``, uploaded once per
    (sizes, device) and cached.  A lookup costs one pass over the sizes
    (their sum picks the entry, an exact comparison confirms it), not a
    hash of them.  A regen runs it after its launches, under the kernel
    (``confirm_tables``), not before them."""
    device = _device(device)
    sizes = np.asarray(shard_sizes, dtype=np.int64).reshape(-1)
    key = (str(device), sizes.size, int(sizes.sum()))
    tabs = _tables.get(key)
    if tabs is None or not np.array_equal(tabs.sizes, sizes):
        tabs = ShardTables(sizes, device)
        if len(_tables) >= _TABLES_CAP:
            _tables.pop(next(iter(_tables)))
        _tables[key] = tabs
    return tabs


def remembered_tables(shard_sizes, device) -> Optional[ShardTables]:
    """The tables that the last regen over this same ``shard_sizes`` object
    on ``device`` confirmed, or None.  Found in O(1), by the object and
    not by its values: a guess to launch with, which ``confirm_tables``
    holds to the sizes afterwards."""
    with _lock:
        held = _confirmed.get(_remember_key(shard_sizes, _device(device)))
    return None if held is None else held[1]


def confirm_tables(shard_sizes, device, guess=None) -> ShardTables:
    """The tables of ``shard_sizes`` on ``device``, remembered for the next
    regen over this ``shard_sizes`` object there: the ``guess`` a regen
    launched with when it holds exactly these sizes (a hit in
    ``table_checks``), else ``shard_tables``'s (a miss, where there was a
    guess).  The guess is held to the sizes themselves, not to the cache,
    so that arrays of one length and sum taking turns, which share an
    entry of ``shard_tables``, still hit."""
    if guess is not None and np.array_equal(
            guess.sizes, np.asarray(shard_sizes, dtype=np.int64).reshape(-1)):
        tables = guess
    else:
        tables = shard_tables(shard_sizes, device)
    key = _remember_key(shard_sizes, tables.device)
    with _lock:
        if guess is not None:
            table_checks["hits" if tables is guess else "misses"] += 1
        if key not in _confirmed and len(_confirmed) >= _TABLES_CAP:
            _confirmed.pop(next(iter(_confirmed)))
        _confirmed[key] = (shard_sizes, tables)
    return tables
