"""Mixture-of-sources stream (SPEC.md §8): weighted multi-dataset sampling.

The multi-corpus pretrain shape (web + code + books at fixed
proportions): each source is partially shuffled by its own §3 windowed
permutation, and sources interleave at exact per-block proportions through
a static smooth round-robin pattern, rotated per block by a keyed offset
in pattern version 2.  The stream is a pure function of
``(spec, seed, epoch, position)``, so it partitions across ranks,
checkpoints and resumes like the single-source stream.

The law here is plain torch ops on any device, with the port's integer
representation (``ops/core.py``: uint32 lanes as int64 masked to 32 bits,
uint64 positions as plain int64).  Three evaluators give the same values:

* the fused per-lane evaluator (``_fused_mixture_eval``): one §3 program
  over all lanes with per-lane source parameters gathered from [S]
  tables.  It is the plain version of the ``mixture_fused`` CUDA kernel
  (``ops/cuda_kernel.py``, ``csrc/mixture_kernels.cu``);
* the masked per-source loop (``fused=False``), S full-lane passes, with
  the amortized per-source evaluation (``_amortized_source_perm``) where
  its pass tables stay small.  Evaluated per lane (``amortize=False``) it
  is the plain version of the ``mixture_fused_wide`` kernel;
* the kernels themselves.

The JAX package's packed slot and rotation tables (``packed_slot_table``,
``packed_rot_table``, ``_SELECT_CAP``, ``_ROT_PACK_LANES_CAP``) are
evaluation strategies for the TPU's gathers; they change no value and are
not carried over.

Entry points: ``mixture_epoch_indices_cuda``, ``mixture_stream_at_cuda``
and ``mixture_elastic_indices_cuda`` run on the card by default (their
``_cpu`` twins run the plain law on the host).  On a CUDA device every
regen launches a kernel: ``mixture_fused`` where every source is below
2^31 and ``fused`` is not False; otherwise ``mixture_fused_wide``, the
masked evaluator's kernel, which serves a source of 2^31 or more (where
the JAX package also leaves its fused path) and ``fused=False``.  Either
derives the per-source keys itself while they are few
(``cuda_kernel.mixture_folds``), else ``mixture_source_keys`` runs first.
``fused=True`` where the fused law does not apply raises, as the plain
law does.  No mixture evaluator runs as torch ops on the card, and no
path turns to one when a kernel fails to build or launch.
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import core, cuda_kernel

#: per-source seed stride (SPEC.md §8.3): a 64-bit odd constant distinct
#: from the shard-mode stride (§7.1)
_MIX_SEED_STRIDE = 0xB5297A4D2C7E9FD3
#: pass-folding constant (§8.3)
_C_PASS = 0x632BE5AB
#: §8.2a (v2) per-block rotation constant
_C_ROT = 0x6A09E667
_M64 = 0xFFFFFFFFFFFFFFFF

DEFAULT_BLOCK = 1024

#: amortized-evaluator guard: combined per-source table elements
#: (P * (nw + tail)) beyond this take the per-lane path
_TABLE_CAP = 8_000_000


def source_seed(seed: int, s: int) -> int:
    """§8.3: the per-source seed, evaluated in unbounded integers, then
    folded per §1 by the key schedule."""
    return int(seed) ^ (_MIX_SEED_STRIDE + int(s))


def _seed_stride_halves(s: int) -> tuple:
    """(lo, hi) uint32 halves of source ``s``'s seed offset."""
    d = (_MIX_SEED_STRIDE + int(s)) & _M64
    return d & core._M32, (d >> 32) & core._M32


class MixtureSpec:
    """Validated, immutable mixture description: quotas + static tables.

    sources: sizes ``n_s`` (>= 1 each).
    weights: integer weights ``v_s`` (>= 1 each; proportions ``v_s/V``).
    windows: per-source window, or one shared int (default
        ``core.DEFAULT_WINDOW``); each is capped at its source size, so
        the list and the int spellings of a window give the same stream.
    block:   pattern block size B (§8.1); every aligned B-block realises
        the quotas exactly.
    pattern_version: 2 (default, §8.2a) rotates the slot pattern per
        block by a keyed offset when ``shuffle=True``; 1 reproduces the
        static pattern of spec-v1 checkpoints.

    Raises when a source would get no slot of a block (``k_s == 0``),
    naming a block size that serves it.  The JAX package's
    ``MixtureSpec``, without its TPU gather tables: the same arguments
    give the same quotas, pattern, prefix counts and errors.
    """

    def __init__(
        self,
        sources: Sequence[int],
        weights: Sequence[int],
        *,
        windows=None,
        block: int = DEFAULT_BLOCK,
        pattern_version: int = 2,
    ) -> None:
        self.sources = tuple(int(n) for n in sources)
        self.weights = tuple(int(v) for v in weights)
        if not self.sources:
            raise ValueError("mixture needs at least one source")
        if len(self.weights) != len(self.sources):
            raise ValueError(
                f"{len(self.sources)} sources but {len(self.weights)} weights"
            )
        for s, n in enumerate(self.sources):
            if n < 1:
                raise ValueError(f"source {s} has size {n}; must be >= 1")
        for s, v in enumerate(self.weights):
            if v < 1:
                raise ValueError(
                    f"source {s} has weight {v}; must be >= 1 (drop "
                    "zero-weight sources before building the spec)"
                )
        S = len(self.sources)
        if windows is None:
            windows = core.DEFAULT_WINDOW
        if isinstance(windows, (int, np.integer)):
            windows = [int(windows)] * S
        windows = tuple(int(w) for w in windows)
        if len(windows) != S:
            raise ValueError(
                f"{S} sources but {len(windows)} windows"
            )
        for s, w in enumerate(windows):
            if w < 1:
                raise ValueError(f"window for source {s} must be >= 1, got {w}")
        self.windows = tuple(
            min(w, n) for w, n in zip(windows, self.sources)
        )
        if int(pattern_version) not in (1, 2):
            raise ValueError(
                f"pattern_version must be 1 or 2, got {pattern_version}"
            )
        self.pattern_version = int(pattern_version)
        self.block = int(block)
        if self.block < S:
            raise ValueError(
                f"block {self.block} < {S} sources; every source needs a slot"
            )
        # --- §8.1 quotas: largest-remainder apportionment ------------------
        V = sum(self.weights)
        floors = [v * self.block // V for v in self.weights]
        rems = [(v * self.block) % V for v in self.weights]
        left = self.block - sum(floors)
        # ties toward smaller s: sort by (-remainder, s)
        for s in sorted(range(S), key=lambda s: (-rems[s], s))[:left]:
            floors[s] += 1
        for s, k in enumerate(floors):
            if k == 0:
                need = -(-V // self.weights[s])
                raise ValueError(
                    f"source {s} (weight {self.weights[s]}/{V}) gets 0 of "
                    f"{self.block} block slots; block >= {need} suffices"
                )
        self.quotas = tuple(floors)
        # --- §8.2 pattern: smooth round-robin ------------------------------
        err = np.zeros(S, dtype=np.int64)
        k_arr = np.asarray(floors, dtype=np.int64)
        pattern = np.empty(self.block, dtype=np.int32)
        prefix = np.zeros((self.block, S), dtype=np.int64)
        counts = np.zeros(S, dtype=np.int64)
        for t in range(self.block):
            prefix[t] = counts
            s_star = int(np.argmax(err + k_arr))  # argmax ties -> smallest s
            pattern[t] = s_star
            err += k_arr
            err[s_star] -= self.block
            counts[s_star] += 1
        pattern.setflags(write=False)
        prefix.setflags(write=False)
        self.pattern = pattern  # [B] int32
        self.prefix = prefix  # [B, S] int64: C_s(t)
        bases = np.concatenate([[0], np.cumsum(self.sources)[:-1]])
        self.bases = tuple(int(b) for b in bases)
        self.total_sources_len = int(sum(self.sources))

    # ------------------------------------------------------------------ info
    @property
    def num_sources(self) -> int:
        return len(self.sources)

    def key(self) -> tuple:
        """Hashable identity (device-table cache key, checkpoint field)."""
        return (self.sources, self.weights, self.windows, self.block,
                self.pattern_version)

    @classmethod
    def from_key(cls, key: tuple) -> "MixtureSpec":
        """Rebuild a spec from :meth:`key`."""
        sources, weights, windows, block, pattern_version = key
        return cls(sources, weights, windows=list(windows), block=block,
                   pattern_version=pattern_version)

    def rotated(self, shuffle: bool) -> bool:
        """Whether the §8.2a per-block slot rotation applies: v2 specs with
        ``shuffle=True``.  ``shuffle=False`` keeps the stream a pure
        deterministic interleave."""
        return bool(shuffle) and self.pattern_version >= 2

    def out_dtype(self) -> torch.dtype:
        """Id dtype: int32 when the concatenated id space fits, else
        int64."""
        return core.out_dtype(self.total_sources_len)

    def fused_applies(self) -> bool:
        """Whether every source is below 2^31, where the fused per-lane
        evaluation (and the ``mixture_fused`` kernel) takes the stream."""
        return max(self.sources) <= core.INT32_MAX

    def decompose(self, global_ids):
        """Split global ids back into (source_id, local_id) arrays."""
        gids = np.asarray(global_ids)
        bases = np.asarray(self.bases + (self.total_sources_len,))
        s = np.searchsorted(bases, gids, side="right") - 1
        return s.astype(np.int32), gids - bases[s]

    def rank_slot_counts(self, rank: int, world: int) -> np.ndarray:
        """Per-source counts over the static pattern slots a strided rank
        visits (its orbit ``(rank + world*k) mod B``).  Exact for
        position-static streams (``pattern_version=1`` or
        ``shuffle=False``)."""
        g = np.gcd(int(world), self.block)
        orbit = (int(rank) + int(world) * np.arange(self.block // g)) \
            % self.block
        return np.bincount(self.pattern[orbit],
                           minlength=self.num_sources)

    def check_rank_balance(self, rank: int, world: int, partition: str,
                           shuffle: bool = True) -> None:
        """Warn when a strided rank's orbit starves a source.  A no-op for
        v2 shuffled streams, whose per-block rotation sweeps every orbit
        across all pattern slots."""
        if self.rotated(shuffle):
            return
        if partition != "strided" or np.gcd(int(world), self.block) == 1:
            return  # blocked ranks cover whole blocks; coprime = all slots
        counts = self.rank_slot_counts(rank, world)
        starved = [s for s in range(self.num_sources) if counts[s] == 0]
        if starved:
            warnings.warn(
                f"mixture rank {rank} of {world}: strided positions visit "
                f"only {self.block // np.gcd(int(world), self.block)} of "
                f"{self.block} pattern slots and NEVER draw source(s) "
                f"{starved} (gcd(world, block)="
                f"{np.gcd(int(world), self.block)}); choose a block size "
                "coprime to the world size, partition='blocked', or a "
                "pattern_version=2 shuffled stream (immune by rotation)",
                stacklevel=3,
            )

    def check_world_balance(self, world: int, partition: str,
                            shuffle: bool = True) -> None:
        """:meth:`check_rank_balance` for every rank of a world at once:
        only ``gcd(world, B)`` distinct orbits exist."""
        if self.rotated(shuffle):
            return
        if partition != "strided" or np.gcd(int(world), self.block) == 1:
            return
        g = int(np.gcd(int(world), self.block))
        bad = []
        for cls_rank in range(g):
            counts = self.rank_slot_counts(cls_rank, world)
            starved = [s for s in range(self.num_sources) if counts[s] == 0]
            if starved:
                bad.append((cls_rank, starved))
        if bad:
            warnings.warn(
                f"mixture over world {world}: strided rank classes "
                f"{[r for r, _ in bad]} (mod gcd(world, block)={g}) NEVER "
                f"draw source(s) {sorted({s for _, ss in bad for s in ss})}; "
                "choose a block size coprime to the world size, "
                "partition='blocked', or a pattern_version=2 shuffled "
                "stream (immune by rotation)",
                stacklevel=3,
            )


def source_seed_folded(seed, s: int):
    """(lo, hi) uint32 pair for source ``s``.  §8.3's unbounded-int XOR
    decomposes bitwise over the folded halves, so this takes ints and
    folded ``(lo, hi)`` pairs of 0-d tensors alike (the agreed seed triple
    of ``parallel/``, which never visits the host)."""
    d_lo, d_hi = _seed_stride_halves(s)
    lo, hi = core.fold_seed(seed)
    return core.as_u32_scalar(lo) ^ d_lo, core.as_u32_scalar(hi) ^ d_hi


def mixture_epoch_sizes(
    spec: MixtureSpec, epoch_samples: Optional[int], world: int,
    drop_last: bool,
) -> Tuple[int, int, int]:
    """(T, num_samples, total_size): §8.4's length law over T."""
    T = spec.total_sources_len if epoch_samples is None else int(epoch_samples)
    if T < 1:
        raise ValueError(f"epoch_samples must be >= 1, got {T}")
    num_samples, total = core.shard_sizes(T, world, drop_last)
    return T, num_samples, total


def wide_positions(max_position: int, spec: MixtureSpec) -> bool:
    """Whether positions up to ``max_position`` need uint64 math (they
    and a block past them reach 2^31)."""
    return int(max_position) + spec.block >= core.INT32_MAX


def rotation_key(seed, epoch):
    """§8.2a rotation key ``rk``: from the epoch key of the UNSOURCED seed
    (a per-source key here would give another stream)."""
    return core.mix32(core.derive_epoch_key(seed, epoch) ^ _C_ROT)


def _tensor(vals, device) -> torch.Tensor:
    return torch.tensor(np.asarray(vals, dtype=np.int64), device=device)


def _lane_slots(p: torch.Tensor, spec: MixtureSpec, seed, epoch,
                shuffle: bool, wide: bool):
    """Per lane: ``(slot, rot, wrap, blk)``.  ``slot`` is the pattern slot
    the position draws, ``blk`` its block; ``rot``/``wrap`` are the §8.2a
    rotation and whether the rotated slot wrapped past B (None for static
    patterns).  ``wide``: ``p`` holds uint64 bits (``core.u64_divmod``)."""
    B = spec.block
    blk, t = core.u64_divmod(p, B) if wide else (p // B, p % B)
    if not spec.rotated(shuffle):
        return t, None, None, blk
    rk = rotation_key(seed, epoch)
    rot = core.mix32(rk ^ (blk & core._M32)) % B  # keys on blk mod 2^32
    a = t + rot
    wrap = a >= B
    return torch.where(wrap, a - B, a), rot, wrap, blk


def _swap_or_not_lanes(x, m_lane, msafe_src, key_lane, pair_src,
                       rounds: int, idx):
    """swap-or-not with a per-lane modulus: the engine of the fused
    evaluation.  Per lane equal to ``core.swap_or_not(x, m, key,
    pair_key=pair)`` with that lane's ``(m, pair)``: the pairing constants
    ``K_r = mix32(pair ^ r*GOLDEN) % m`` depend on (class, round) only, so
    they are computed on the [C] class vectors and gathered per lane by
    ``idx``.  Lanes with ``m <= 1`` pass through; ``msafe_src`` lifts a
    class modulus of 0 to 1 so the table never divides by zero."""
    key2 = core.mix32(key_lane ^ core._C_BIT)
    m_ok = m_lane > 1
    for r in range(rounds):
        kr_src = core.mix32(
            pair_src ^ ((r * core._GOLDEN) & core._M32)
        ) % msafe_src
        k_r = kr_src[idx]
        partner = (k_r + ((m_lane - x) & core._M32)) & core._M32
        partner = torch.where(partner >= m_lane, partner - m_lane, partner)
        c = torch.where(x > partner, x, partner)
        b = core.mix32(c ^ key2 ^ ((r * core._RC_BIT) & core._M32))
        x = torch.where(((b & 1) == 1) & m_ok, partner, x)
    return x


def _source_tables(spec: MixtureSpec, device) -> dict:
    """[S] int64 tensors of the per-source law parameters."""
    n = np.asarray(spec.sources, dtype=np.int64)
    w = np.asarray(spec.windows, dtype=np.int64)
    nw = n // w  # >= 1: windows are capped at n_s
    tail = n - nw * w
    return {
        "n": _tensor(n, device), "w": _tensor(w, device),
        "nw": _tensor(nw, device), "body": _tensor(nw * w, device),
        "tail": _tensor(tail, device),
        "tail_safe": _tensor(np.maximum(tail, 1), device),
        "k": _tensor(spec.quotas, device),
        "bases": _tensor(spec.bases, device),
        "pattern": _tensor(spec.pattern, device),
        "prefix": _tensor(spec.prefix.reshape(-1), device),
        "any_tail": bool((tail > 0).any()),
    }


def _draws(spec: MixtureSpec, tab: dict, slot, rot, wrap, blk, wide: bool):
    """Per lane: source ``s``, its pass counter ``pas`` and its in-pass
    offset ``u``.  ``cnt`` (the source's draws before this slot in the
    block) is non-negative only with the ``wrap * k_s`` term."""
    S = spec.num_sources
    s = tab["pattern"][slot]
    k = tab["k"][s]
    cnt = tab["prefix"][slot * S + s]
    if rot is not None:
        cnt = cnt + torch.where(wrap, k, torch.zeros_like(k)) \
            - tab["prefix"][rot * S + s]
    j = core.wrap_pos(blk * k + cnt, wide)
    n = tab["n"][s]
    pas, u = core.u64_divmod(j, n) if wide else (j // n, j % n)
    return s, pas & core._M32, u


def lane_draws(positions: torch.Tensor, spec: MixtureSpec, seed, epoch, *,
               shuffle: bool = True, wide: bool = False):
    """Per position: its source ``s``, the source's pass and its in-pass
    offset ``u`` (int64 tensors on the positions' device).  A lane is a
    tail lane of its source where ``u >= nw_s * W_s``."""
    p = core.wrap_pos(positions.to(torch.int64), wide)
    slot, rot, wrap, blk = _lane_slots(p, spec, seed, epoch, shuffle, wide)
    return _draws(spec, _source_tables(spec, p.device), slot, rot, wrap, blk,
                  wide)


def _source_keys(spec: MixtureSpec, seed, epoch, device):
    """[S] per-source (lo, hi) seed halves and pass-free epoch keys."""
    lo0, hi0 = core.fold_seed(seed)
    halves = [_seed_stride_halves(s) for s in range(spec.num_sources)]
    lo_s = core.as_u32_scalar(lo0) ^ _tensor([h[0] for h in halves], device)
    hi_s = core.as_u32_scalar(hi0) ^ _tensor([h[1] for h in halves], device)
    return lo_s, hi_s, core.derive_epoch_key((lo_s, hi_s), epoch)


def _fused_mixture_eval(spec: MixtureSpec, slot, rot, wrap, blk, seed,
                        epoch, order_windows: bool, rounds: int,
                        wide: bool) -> torch.Tensor:
    """Single-pass §8.3 stream: ONE §3 program over all lanes with
    per-lane (n, W, nw, tail, keys) gathered from [S] tables, O(len) work
    for any source count.  Equal to the masked per-source loop (same
    bijections, same keys, per lane instead of per source); every source
    must be below 2^31.  The plain version of the ``mixture_fused``
    kernel."""
    dev = slot.device
    tab = _source_tables(spec, dev)
    S = spec.num_sources
    s, pas, u = _draws(spec, tab, slot, rot, wrap, blk, wide)
    lo_s, hi_s, ek0 = _source_keys(spec, seed, epoch, dev)
    # per-lane decision keys: the pass-folded epoch (§8.3) varies per
    # lane; the pairing constants come from the pass-free ek0
    ep_u = core.mix32(core.as_u32_scalar(epoch)
                      ^ core.mix32(pas ^ _C_PASS))
    ek = core.derive_epoch_key((lo_s[s], hi_s[s]), ep_u)
    w_l, nw_l, body_l = tab["w"][s], tab["nw"][s], tab["body"][s]
    win = torch.minimum(u // w_l, nw_l - 1)  # tail lanes clipped, unused
    r0 = u % w_l
    if order_windows:
        k = _swap_or_not_lanes(win, nw_l, tab["nw"], core.outer_key(ek),
                               core.outer_key(ek0), rounds, s)
    else:
        k = win
    kin = core.inner_key(ek, k)
    if tab["any_tail"]:
        # inner and tail bijections in ONE pass with per-lane (m, key) and
        # a [2S]-class pairing table: a lane is a body lane or a tail lane
        is_tail = u >= body_l
        tpos = torch.where(is_tail, u - body_l, torch.zeros_like(u))
        tpos = torch.minimum(tpos, tab["tail_safe"][s] - 1)
        rho = _swap_or_not_lanes(
            torch.where(is_tail, tpos, r0),
            torch.where(is_tail, tab["tail"][s], w_l),
            torch.cat([tab["w"], tab["tail_safe"]]),
            torch.where(is_tail, core.tail_key(ek), kin),
            torch.cat([core.inner_pair_key(ek0), core.tail_key(ek0)]),
            rounds, s + torch.where(is_tail, S, 0),
        )
        idx = torch.where(is_tail, body_l + rho, k * w_l + rho)
    else:
        rho = _swap_or_not_lanes(r0, w_l, tab["w"], kin,
                                 core.inner_pair_key(ek0), rounds, s)
        idx = k * w_l + rho
    return (tab["bases"][s] + idx).to(spec.out_dtype())


def _amortized_source_perm(u, pas, n_s: int, W: int, seed_pair, ep, P: int,
                           order_windows: bool, rounds: int):
    """§3 permutation over [0, n_s) with the §8.3 split key schedule,
    evaluated the amortized way: the outer (window-order) and tail
    bijections once per (pass, domain element) as small [P, nw] / [P,
    tail] tables, looked up per lane; only the inner bijection runs per
    lane.  Equal to ``core.windowed_perm`` with the same keys."""
    dev = u.device
    nw = n_s // W
    body_len = nw * W
    tail_len = n_s - body_len
    qs = torch.arange(P, dtype=torch.int64, device=dev)
    ep_s = core.as_u32_scalar(ep)
    ep_q = core.mix32(ep_s ^ core.mix32(qs ^ _C_PASS))
    ek_q = core.derive_epoch_key(seed_pair, ep_q)  # [P] decision keys
    ek0 = core.derive_epoch_key(seed_pair, ep_s)  # pass-free pairing key
    # pass clipped for gather safety (only other sources' lanes exceed it)
    pas_c = torch.clamp(pas, max=P - 1)
    ek_lane = ek_q[pas_c]
    if nw > 0:
        win = torch.clamp(u // W, max=nw - 1)
        r0 = u % W
        if order_windows and nw > 1:
            j_dom = torch.arange(nw, dtype=torch.int64, device=dev)[None, :]
            outer_tab = core.swap_or_not(
                j_dom, nw, core.outer_key(ek_q)[:, None], rounds,
                pair_key=core.outer_key(ek0),
            )  # [P, nw]
            k = outer_tab[pas_c, win]
        else:
            k = win
        kin = core.inner_key(ek_lane, k)
        rho = core.swap_or_not(r0, W, kin, rounds,
                               pair_key=core.inner_pair_key(ek0))
        body_idx = k * W + rho
    else:
        body_idx = u
    if tail_len > 0:
        if tail_len == 1:
            tail_vals = torch.zeros_like(u)  # a domain of one: identity
        else:
            tpos = torch.where(u >= body_len, u - body_len,
                               torch.zeros_like(u))
            tpos = torch.clamp(tpos, max=tail_len - 1)
            t_dom = torch.arange(tail_len, dtype=torch.int64,
                                 device=dev)[None, :]
            tail_tab = core.swap_or_not(
                t_dom, tail_len, core.tail_key(ek_q)[:, None], rounds,
                pair_key=core.tail_key(ek0),
            )  # [P, tail]
            tail_vals = tail_tab[pas_c, tpos]
        tail_idx = body_len + tail_vals
        if nw > 0:
            return torch.where(u < body_len, body_idx, tail_idx)
        return tail_idx
    return body_idx


def _max_pass(max_position: Optional[int], spec: MixtureSpec,
              s: int) -> Optional[int]:
    """Upper bound on a source's pass counter over positions
    ``<= max_position``: ``j <= (pmax // B) * k_s + k_s - 1``."""
    if max_position is None:
        return None
    j_max = (int(max_position) // spec.block) * spec.quotas[s] \
        + spec.quotas[s] - 1
    return j_max // spec.sources[s] + 1


def _masked_mixture_eval(spec: MixtureSpec, p, slot, rot, wrap, blk, seed,
                         epoch, *, shuffle: bool, order_windows: bool,
                         rounds: int, wide: bool, amortize: bool,
                         max_position: Optional[int]) -> torch.Tensor:
    """The masked per-source loop: S full-lane passes, each lane keeping
    the pass of its own source.  The reference evaluator, the host's route
    of sources >= 2^31, and (per lane) the plain version of the
    ``mixture_fused_wide`` kernel."""
    tab = _source_tables(spec, p.device)
    s_arr = tab["pattern"][slot]
    out_dtype = spec.out_dtype()
    out = torch.zeros(p.shape, dtype=out_dtype, device=p.device)
    n_lanes = p.numel()
    for s in range(spec.num_sources):
        n_s, k_s, W_s = spec.sources[s], spec.quotas[s], spec.windows[s]
        c_s = _tensor(np.ascontiguousarray(spec.prefix[:, s]), p.device)
        cnt = c_s[slot]
        if rot is not None:
            # draws of s over the circular slot range [rot, rot+t)
            cnt = cnt + torch.where(wrap, k_s, 0) - c_s[rot]
        j = core.wrap_pos(blk * k_s + cnt, wide)
        pas, u = core.u64_divmod(j, n_s) if wide else (j // n_s, j % n_s)
        pas = pas & core._M32
        if shuffle:
            seed_pair = source_seed_folded(seed, s)
            P = _max_pass(max_position, spec, s)
            table = None if P is None else P * (n_s // W_s + n_s % W_s)
            if (table is not None and table <= _TABLE_CAP
                    # tables must pay for themselves: not for a handful of
                    # random-access probes
                    and table <= 4 * n_lanes):
                idx = _amortized_source_perm(u, pas, n_s, W_s, seed_pair,
                                             epoch, P, order_windows, rounds)
            else:
                ep = core.as_u32_scalar(epoch)
                ep_u = core.mix32(ep ^ core.mix32(pas ^ _C_PASS))
                idx = core.windowed_perm(
                    u, n_s, W_s, core.derive_epoch_key(seed_pair, ep_u),
                    order_windows=order_windows, rounds=rounds,
                    pair_epoch_key=core.derive_epoch_key(seed_pair, ep),
                )
        else:
            idx = u
        out = torch.where(s_arr == s, (spec.bases[s] + idx).to(out_dtype),
                          out)
    return out


def mixture_stream_at_generic(
    positions,
    spec: MixtureSpec,
    seed,
    epoch,
    *,
    shuffle: bool = True,
    order_windows: bool = True,
    rounds: int = core.DEFAULT_ROUNDS,
    big_positions: Optional[bool] = None,
    amortize: bool = True,
    max_position: Optional[int] = None,
    fused: Optional[bool] = None,
) -> torch.Tensor:
    """§8.3: global ids for arbitrary mixture positions (not wrapped: the
    mixture stream is total), plain torch ops on the device of
    ``positions``.  int32 ids when the concatenated id space fits, else
    int64.  ``big_positions`` (uint64 position math) and ``max_position``
    (the amortized tables' pass bound) are read off the positions when
    not given.  ``fused`` picks the per-lane evaluator (default wherever
    it applies: ``shuffle`` and every source < 2^31) or, ``False``, the
    masked per-source loop; the values are the same."""
    p = torch.as_tensor(positions).to(torch.int64)
    if big_positions is None or (amortize and max_position is None):
        pmax = int(p.max()) if p.numel() else 0
        if big_positions is None:
            big_positions = wide_positions(pmax, spec)
        if max_position is None:
            max_position = pmax
    wide = bool(big_positions)
    p = core.wrap_pos(p, wide)
    slot, rot, wrap, blk = _lane_slots(p, spec, seed, epoch, shuffle, wide)
    fused_ok = bool(shuffle) and spec.fused_applies()
    if fused is None:
        use_fused = fused_ok
    else:
        use_fused = bool(fused)
        if use_fused and not fused_ok:
            raise ValueError(
                "fused evaluation requires shuffle=True and every source "
                "size < 2^31; pass fused=False (or None) here"
            )
    if use_fused:
        return _fused_mixture_eval(spec, slot, rot, wrap, blk, seed, epoch,
                                   order_windows, rounds, wide)
    return _masked_mixture_eval(
        spec, p, slot, rot, wrap, blk, seed, epoch, shuffle=shuffle,
        order_windows=order_windows, rounds=rounds, wide=wide,
        amortize=amortize, max_position=max_position,
    )


def rank_stream_positions(spec: MixtureSpec, rank, world: int,
                          num_samples: int, partition: str, wide: bool,
                          device=None) -> torch.Tensor:
    """Rank's mixture-stream positions (int64), NOT wrapped mod T: padding
    positions extend the stream, so exact proportions survive padding."""
    if partition not in ("strided", "blocked"):
        raise ValueError(
            f"partition must be 'strided' or 'blocked', got {partition!r}"
        )
    ar = torch.arange(num_samples, dtype=torch.int64, device=device)
    if partition == "strided":
        return core.wrap_pos(rank + world * ar, wide)
    return core.wrap_pos(rank * num_samples + ar, wide)


def mixture_epoch_indices_generic(
    spec: MixtureSpec,
    seed,
    epoch,
    rank,
    world: int,
    *,
    epoch_samples: Optional[int] = None,
    shuffle: bool = True,
    drop_last: bool = False,
    order_windows: bool = True,
    partition: str = "strided",
    rounds: int = core.DEFAULT_ROUNDS,
    amortize: bool = True,
    fused: Optional[bool] = None,
    device=None,
) -> torch.Tensor:
    """Rank's mixture-epoch global ids (§8.4) by the plain law on
    ``device``."""
    _T, num_samples, total = mixture_epoch_sizes(
        spec, epoch_samples, world, drop_last
    )
    wide = total + spec.block > core.INT32_MAX
    p = rank_stream_positions(spec, rank, world, num_samples, partition,
                              wide, device)
    return mixture_stream_at_generic(
        p, spec, seed, epoch, shuffle=shuffle, order_windows=order_windows,
        rounds=rounds, big_positions=wide, amortize=amortize,
        max_position=total - 1, fused=fused,
    )


def _elastic_plan(spec: MixtureSpec, layers, world: int,
                  epoch_samples: Optional[int], drop_last: bool):
    """``(chain, remaining, num_samples, base_total, wide)`` of a reshard
    cascade over the mixture-epoch length."""
    T = spec.total_sources_len if epoch_samples is None else int(epoch_samples)
    chain, remaining, num_samples = core.elastic_chain(
        T, layers, world, drop_last
    )
    base_total = chain[0][1] * chain[0][0]  # ns_0 * world_0
    return (chain, remaining, num_samples, base_total,
            base_total + spec.block > core.INT32_MAX)


def elastic_positions(chain, remaining: int, rank, world: int,
                      num_samples: int, partition: str, wide: bool,
                      device=None) -> torch.Tensor:
    """Base-epoch stream positions of the rank's remainder share (SPEC.md
    §6; the law is stream-agnostic), with torch ops on ``device``."""
    q = core.rank_positions(remaining, rank, world, num_samples, partition,
                            wide, device)
    return core.compose_remainder_chain(q, chain, partition, wide)


def mixture_elastic_indices_generic(
    spec: MixtureSpec,
    seed,
    epoch,
    rank,
    world: int,
    layers,
    *,
    epoch_samples: Optional[int] = None,
    shuffle: bool = True,
    drop_last: bool = False,
    order_windows: bool = True,
    partition: str = "strided",
    rounds: int = core.DEFAULT_ROUNDS,
    amortize: bool = True,
    fused: Optional[bool] = None,
    device=None,
) -> torch.Tensor:
    """Elastic remainder-epoch mixture stream (SPEC.md §6 over §8) by the
    plain law: the remainder ordinals map to base-epoch positions, which
    evaluate through the mixture stream.  ``layers`` is the checkpoint
    cascade ``[(world, consumed), ...]`` outermost first."""
    chain, remaining, ns, base_total, wide = _elastic_plan(
        spec, layers, world, epoch_samples, drop_last
    )
    if remaining == 0 or ns == 0:
        return torch.empty(0, dtype=spec.out_dtype(), device=device)
    pos = elastic_positions(chain, remaining, rank, world, ns, partition,
                            wide, device)
    return mixture_stream_at_generic(
        pos, spec, seed, epoch, shuffle=shuffle, order_windows=order_windows,
        rounds=rounds, big_positions=wide, amortize=amortize,
        max_position=base_total - 1, fused=fused,
    )


def build_mixture_evaluator(
    spec: MixtureSpec,
    world: int,
    *,
    epoch_samples: Optional[int] = None,
    shuffle: bool = True,
    drop_last: bool = False,
    order_windows: bool = True,
    partition: str = "strided",
    rounds: int = core.DEFAULT_ROUNDS,
    amortize: bool = True,
    fused: Optional[bool] = None,
    device,
):
    """The plain torch mixture evaluator ``fn(seed, epoch, rank) -> ids``
    of a static config on ``device`` (required: the plain law runs
    wherever it is asked to).  ``seed`` may be a folded ``(lo, hi)`` pair
    of 0-d tensors and ``epoch`` a 0-d tensor, as the agreed triple
    gives them."""
    mixture_epoch_sizes(spec, epoch_samples, int(world), bool(drop_last))

    def fn(seed, epoch, rank):
        return mixture_epoch_indices_generic(
            spec, seed, epoch, rank, int(world),
            epoch_samples=epoch_samples, shuffle=shuffle,
            drop_last=drop_last, order_windows=order_windows,
            partition=partition, rounds=rounds, amortize=amortize,
            fused=fused, device=device,
        )

    return fn


# ---------------------------------------------------------------- entries
def _kernel_route(spec: MixtureSpec, device, fused: Optional[bool],
                  shuffle: bool):
    """The kernel wrapper a regen on ``device`` launches, or None off the
    card (the plain law): ``mixture_fused`` where every source is below
    2^31 and ``fused`` is not False, else ``mixture_fused_wide``.
    ``fused=True`` where the fused law does not apply raises, as the plain
    law does."""
    if cuda_kernel.device_kind(device) != "cuda":
        return None
    if fused and not (shuffle and spec.fused_applies()):
        raise ValueError(
            "fused evaluation requires shuffle=True and every source "
            "size < 2^31; pass fused=False (or None) here"
        )
    if fused is not False and spec.fused_applies():
        return cuda_kernel.mixture_fused
    return cuda_kernel.mixture_fused_wide


def _route_keys(spec: MixtureSpec, seed, epoch, rounds: int, device,
                triple):
    """The keys argument of a kernel regen: None where the mixture kernel
    derives them itself (one launch), else the ``mixture_source_keys``
    buffer (a launch before it)."""
    if cuda_kernel.mixture_folds(spec, rounds):
        return None
    return cuda_kernel.mixture_source_keys(spec, seed, epoch, rounds=rounds,
                                           device=device, triple=triple)


def _check_rank(rank: int, world: int) -> None:
    if int(world) < 1:
        raise ValueError(f"world must be >= 1, got {int(world)}")
    if not 0 <= int(rank) < int(world):
        raise ValueError(f"rank must be in [0, {world}), got {int(rank)}")


def mixture_epoch_indices_cuda(
    spec: MixtureSpec,
    seed,
    epoch,
    rank,
    world: int,
    *,
    epoch_samples: Optional[int] = None,
    shuffle: bool = True,
    drop_last: bool = False,
    order_windows: bool = True,
    partition: str = "strided",
    rounds: int = core.DEFAULT_ROUNDS,
    amortize: bool = True,
    fused: Optional[bool] = None,
    device="cuda",
    triple=None,
) -> torch.Tensor:
    """Rank's mixture-epoch global ids on ``device`` (default: the current
    CUDA device): int32, or int64 when the sources total 2^31 or more.  On
    the card the kernels are launched on the current stream and not waited
    for.  ``triple`` (with ``seed`` and ``epoch`` None) is the seed triple
    as an int32[3] tensor on ``device``, read by the kernels from device
    memory."""
    rank, world = int(rank), int(world)
    _check_rank(rank, world)
    _T, num_samples, total = mixture_epoch_sizes(spec, epoch_samples, world,
                                                 drop_last)
    if partition not in ("strided", "blocked"):
        raise ValueError(
            f"partition must be 'strided' or 'blocked', got {partition!r}"
        )
    with torch.profiler.record_function("psds_mixture_regen"):
        kernel = _kernel_route(spec, device, fused, shuffle)
        if kernel is not None:
            return kernel(
                _route_keys(spec, seed, epoch, rounds, device, triple), spec,
                seed, epoch, rank=rank, world=world,
                num_samples=num_samples, partition=partition,
                wide_pos=total + spec.block > core.INT32_MAX,
                shuffle=shuffle, order_windows=order_windows, rounds=rounds,
                device=device, triple=triple)
        seed_p, epoch_p = cuda_kernel._plain_keys(seed, epoch, triple)
        return mixture_epoch_indices_generic(
            spec, seed_p, epoch_p, rank, world, epoch_samples=epoch_samples,
            shuffle=shuffle, drop_last=drop_last,
            order_windows=order_windows, partition=partition, rounds=rounds,
            amortize=amortize, fused=fused, device=device,
        )


def _stream_at_positions(positions: torch.Tensor, spec: MixtureSpec, seed,
                         epoch, *, shuffle, order_windows, rounds, wide,
                         amortize, max_position, fused, device, triple):
    """Ids of int64 ``positions`` on ``device``: a mixture kernel on the
    card, the plain law on the host."""
    kernel = _kernel_route(spec, device, fused, shuffle)
    if kernel is not None:
        return kernel(
            _route_keys(spec, seed, epoch, rounds, device, triple), spec,
            seed, epoch, positions=positions, wide_pos=wide,
            shuffle=shuffle, order_windows=order_windows, rounds=rounds,
            device=device, triple=triple)
    seed_p, epoch_p = cuda_kernel._plain_keys(seed, epoch, triple)
    return mixture_stream_at_generic(
        positions, spec, seed_p, epoch_p, shuffle=shuffle,
        order_windows=order_windows, rounds=rounds, big_positions=wide,
        amortize=amortize, max_position=max_position, fused=fused,
    )


def mixture_stream_at_cuda(
    positions,
    spec: MixtureSpec,
    seed,
    epoch,
    *,
    shuffle: bool = True,
    order_windows: bool = True,
    rounds: int = core.DEFAULT_ROUNDS,
    big_positions: Optional[bool] = None,
    fused: Optional[bool] = None,
    device="cuda",
) -> torch.Tensor:
    """Random access into the mixture stream on ``device`` (default: the
    current CUDA device; ``positions`` are moved there).  Positions are
    int64, taken as uint32 or (``big_positions``) uint64 bits, as the
    reference casts them.  ``big_positions`` is read off the positions
    when not given, which waits for them."""
    cuda_kernel.device_kind(device)
    p = torch.as_tensor(positions).to(device=device, dtype=torch.int64)
    pmax = int(p.max()) if p.numel() else 0
    if big_positions is None:
        big_positions = wide_positions(pmax, spec)
    with torch.profiler.record_function("psds_mixture_stream_at"):
        return _stream_at_positions(
            p, spec, seed, epoch, shuffle=shuffle,
            order_windows=order_windows, rounds=rounds,
            wide=bool(big_positions), amortize=True, max_position=pmax,
            fused=fused, device=device, triple=None,
        )


def mixture_elastic_indices_cuda(
    spec: MixtureSpec,
    seed,
    epoch,
    rank,
    world: int,
    layers,
    *,
    epoch_samples: Optional[int] = None,
    shuffle: bool = True,
    drop_last: bool = False,
    order_windows: bool = True,
    partition: str = "strided",
    rounds: int = core.DEFAULT_ROUNDS,
    amortize: bool = True,
    fused: Optional[bool] = None,
    device="cuda",
    triple=None,
) -> torch.Tensor:
    """Rank's remainder-epoch mixture ids (SPEC.md §6 over §8) on
    ``device``: the positions are built with torch ops there, then the
    kernels evaluate them (no host read, so ``triple`` may be the agreed
    seed).  An empty tensor of the id dtype when nothing remains."""
    rank, world = int(rank), int(world)
    _check_rank(rank, world)
    cuda_kernel.device_kind(device)
    chain, remaining, ns, base_total, wide = _elastic_plan(
        spec, layers, world, epoch_samples, drop_last
    )
    if remaining == 0 or ns == 0:
        return torch.empty(0, dtype=spec.out_dtype(), device=device)
    with torch.profiler.record_function("psds_mixture_elastic_regen"):
        pos = elastic_positions(chain, remaining, rank, world, ns, partition,
                                wide, device)
        return _stream_at_positions(
            pos, spec, seed, epoch, shuffle=shuffle,
            order_windows=order_windows, rounds=rounds, wide=wide,
            amortize=amortize, max_position=base_total - 1, fused=fused,
            device=device, triple=triple,
        )


def mixture_epoch_indices_cpu(spec, seed, epoch, rank, world, **kw):
    """Rank's mixture-epoch ids on the host: the counterpart of the JAX
    package's ``mixture_epoch_indices_np``."""
    return mixture_epoch_indices_cuda(spec, seed, epoch, rank, world,
                                      device="cpu", **kw)


def mixture_stream_at_cpu(positions, spec, seed, epoch, **kw):
    """Random access into the mixture stream on the host
    (``mixture_stream_at_np``)."""
    return mixture_stream_at_cuda(positions, spec, seed, epoch,
                                  device="cpu", **kw)


def mixture_elastic_indices_cpu(spec, seed, epoch, rank, world, layers,
                                **kw):
    """Remainder-epoch mixture ids on the host
    (``mixture_elastic_indices_np``)."""
    return mixture_elastic_indices_cuda(spec, seed, epoch, rank, world,
                                        layers, device="cpu", **kw)
