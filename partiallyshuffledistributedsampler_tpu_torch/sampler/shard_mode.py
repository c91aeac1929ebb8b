"""Shard-index mode: partial shuffle over *storage shards* (WebDataset tar
shards, tokenized C4 shard files — BASELINE.json configs 3-4).

At billion-sample scale the shuffle unit is often the shard file: shard
order is permuted by the core law with ``n = num_shards``
(``PartialShuffleShardSampler``), and each shard's samples follow in a
within-shard order of their own (SPEC.md §7).  The laws here are the JAX
package's, golden-pinned: the per-shard seed, the within-shard order
(full or windowed), and the bounded shuffle-buffer stream.

Three evaluations of the expansion, one law:

* ``expand_shard_indices_cpu`` — the host reference: shards grouped by
  size, one batched §3 program per class through ``ops/core.py``;
* ``expand_shard_indices_generic`` — every output lane evaluated in stream
  order on a tensor's device, from one record per row: the plain version
  of the CUDA kernels;
* ``expand_shard_indices_cuda`` — the kernels ``shard_row_keys`` and
  ``shard_expand`` of ``csrc/shard_kernels.cu`` (or, for ``device="cpu"``,
  their plain version).

The JAX package splits its device expansion into per-size-class programs,
power-of-two buckets and a scatter to bound its compile count; a kernel
that takes the shard size at run time has no compile count, so nothing of
that split carries over.

The two evaluations on size tables, and the sampler's
``device_epoch_indices``, launch with the tables that the last one over
the same sizes object confirmed, and confirm them after their launches
(``_expand_confirmed``; ``ops/shard.py``).

Traced (``telemetry``), a shard-mode regen is the span
``psds_shard_regen`` (with the regen's device interval on the card) over
the shard order's ``psds_epoch_regen``, ``shard.row_keys`` and
``shard.expand`` (the two launches and the host routing around each),
then ``shard.tables`` (the size tables' lookup, under the kernel, with
``hit``), which a regen with no remembered tables runs first.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional, Sequence, Union

import numpy as np
import torch

from ..ops import core, cuda_kernel as ck
from ..ops.cpu import epoch_indices_cpu
from ..ops import shard
from ..ops.shard import (  # noqa: F401
    _SHARD_SEED_STRIDE,
    _rowwise_swap,
    _shard_epoch_keys,
    shard_seed,
    shard_tables,
    shuffle_mode,
)
from ..telemetry import span as _span
from ..telemetry.trace import NULL_SPAN
from .torch_shim import PartiallyShuffleDistributedSampler

#: shards per block of the generator ``expand_shard_indices``
_EXPAND_BLOCK = 8192
#: element cap of one batched class program of the host reference
_BATCH_ELEMS = 1 << 22


def _within_shard_window(m: int, within_shard_shuffle: Union[bool, int]) -> int:
    """Resolve the within-shard shuffle option to a §3 window size:
    ``True`` -> the whole shard; an int -> ``min(w, m)``; ``False``/``0``
    -> sequential.  A negative window raises ``ValueError``."""
    full, w = shuffle_mode(within_shard_shuffle)
    return m if full else min(w, m)


def shard_sample_order(
    sid: int,
    shard_size: int,
    *,
    seed: int = 0,
    epoch: int = 0,
    within_shard_shuffle: Union[bool, int] = True,
    rounds: int = core.DEFAULT_ROUNDS,
) -> torch.Tensor:
    """Within-shard sample order (local offsets [0, shard_size)) — SPEC.md
    §7: the §3 permutation at ``n = shard_size`` with the per-shard seed,
    as an int64 CPU tensor.  Bounded mode keeps windows in place, so every
    sample moves less than the window from storage order."""
    m = int(shard_size)
    if m <= 0:
        return torch.empty(0, dtype=torch.int64)
    w = _within_shard_window(m, within_shard_shuffle)
    if w <= 1:
        return torch.arange(m, dtype=torch.int64)
    return epoch_indices_cpu(
        m, w, shard_seed(seed, sid), epoch, 0, 1, rounds=rounds,
        order_windows=(within_shard_shuffle is True),
    ).to(torch.int64)


def _validate_sids(sids: np.ndarray, num_shards: int) -> None:
    """An out-of-range shard id would index a different shard's expansion;
    refuse it on every route."""
    if sids.size and (sids.min() < 0 or int(sids.max()) >= num_shards):
        raise ValueError(
            f"shard ids must be in [0, {num_shards}); got range "
            f"[{sids.min()}, {sids.max()}]"
        )


def _size_class_members(m_of: np.ndarray):
    """Yield ``(m, members)`` index arrays grouped by shard size, from one
    stable argsort (O(S log S) for any number of distinct sizes)."""
    order = np.argsort(m_of, kind="stable")
    uniq, starts = np.unique(m_of[order], return_index=True)
    bounds = np.append(starts, len(order))
    for i, m in enumerate(uniq):
        yield int(m), order[bounds[i]:bounds[i + 1]]


def _class_orders(sids: np.ndarray, m: int, *, seed, epoch,
                  within_shard_shuffle, rounds: int) -> torch.Tensor:
    """Within-shard orders of one size class: int64 [len(sids), m], one
    batched §3 program with per-shard keys as a column."""
    w = _within_shard_window(m, within_shard_shuffle)
    if w <= 1:
        return torch.arange(m, dtype=torch.int64).expand(len(sids), m)
    lo, hi = _shard_epoch_keys(torch.from_numpy(sids), seed)
    ek = core.derive_epoch_key((lo[:, None], hi[:, None]), epoch)
    p = torch.arange(m, dtype=torch.int64)[None, :]
    return core.windowed_perm(p, m, w, ek,
                              order_windows=(within_shard_shuffle is True),
                              rounds=rounds)


def expand_shard_indices_cpu(
    shard_ids: Sequence[int],
    shard_sizes: Sequence[int],
    *,
    seed: int = 0,
    epoch: int = 0,
    within_shard_shuffle: Union[bool, int] = True,
    rounds: int = core.DEFAULT_ROUNDS,
) -> torch.Tensor:
    """Expand a rank's shard-id stream into global sample indices on the
    host (int64 CPU tensor): shards grouped by size, each class (in slabs
    of ``_BATCH_ELEMS``) one batched §3 program, written to its rows'
    stream positions.  ``shard_sizes[i]`` is the sample count of shard
    ``i``; the sample index space is the concatenation of shards in id
    order."""
    sizes = np.asarray(shard_sizes, dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    sids = np.asarray(list(shard_ids), dtype=np.int64)
    _validate_sids(sids, len(sizes))
    shuffle_mode(within_shard_shuffle)
    if sids.size == 0:
        return torch.empty(0, dtype=torch.int64)
    m_of = sizes[sids]
    out_starts = np.concatenate([[0], np.cumsum(m_of)[:-1]]).astype(np.int64)
    out = torch.empty(int(m_of.sum()), dtype=torch.int64)
    for m, members in _size_class_members(m_of):
        if m == 0:
            continue
        for i0 in range(0, len(members), max(1, _BATCH_ELEMS // m)):
            sub = members[i0:i0 + max(1, _BATCH_ELEMS // m)]
            orders = _class_orders(
                sids[sub], m, seed=seed, epoch=epoch,
                within_shard_shuffle=within_shard_shuffle, rounds=rounds)
            pos = torch.from_numpy(out_starts[sub][:, None]
                                   + np.arange(m, dtype=np.int64))
            glob = torch.from_numpy(offsets[sids[sub]])[:, None] + orders
            out[pos.reshape(-1)] = glob.reshape(-1)
    return out


def _host_ids(shard_ids) -> np.ndarray:
    if isinstance(shard_ids, torch.Tensor):
        return shard_ids.detach().cpu().numpy().astype(np.int64).reshape(-1)
    return np.asarray(list(shard_ids), dtype=np.int64).reshape(-1)


def _expand(shard_ids, tables, *, seed, epoch, full: bool, w: int,
            rounds: int, triple=None, plain: bool,
            trusted: bool = False) -> torch.Tensor:
    """The expansion on ``tables.device`` in mode ``(full, w)``
    (``shuffle_mode``): the row records, then every lane, by the kernels'
    wrappers or (``plain``) their plain versions.  Sequential mode reads no
    record, so it computes none.

    Shard ids already on the card stay there; ids from the host are
    validated there and uploaded with the inclusive prefix of their sizes
    (O(rows)).  With ids on the card, mixed sizes read the epoch's length
    back (one synchronisation); uniform sizes and ``trusted`` ids (in
    range by construction) need none."""
    w = min(w, core.INT32_MAX)  # shards are below 2^31: min(w, m) is kept
    dev = tables.device
    seq = shard.sequential(full, w)
    if seq:
        ck._plain_keys(seed, epoch, triple)  # the key arguments, checked

        def row_keys(sids, sizes_out):
            return None, tables.dev_sizes[sids.long()] if sizes_out else None
    elif plain:
        seed_p, epoch_p = ck._plain_keys(seed, epoch, triple)

        def row_keys(sids, sizes_out):
            return shard.shard_row_keys_ref(sids, tables.dev_sizes, seed_p,
                                            epoch_p, full=full, w=w,
                                            rounds=rounds)
    else:
        def row_keys(sids, sizes_out):
            return ck.shard_row_keys(sids, tables, seed, epoch, full=full,
                                     w=w, rounds=rounds, sizes_out=sizes_out,
                                     triple=triple)

    if plain:
        def expand(rowtab, sids, ends, lanes):
            return shard.shard_expand_ref(
                rowtab, sids, tables.dev_offsets, ends,
                m_uniform=tables.m_uniform, lanes=lanes, full=full, w=w,
                rounds=rounds, out_dtype=tables.out_dtype)
    else:
        def expand(rowtab, sids, ends, lanes):
            return ck.shard_expand(rowtab, sids, tables, ends, lanes=lanes,
                                   full=full, w=w, rounds=rounds)

    empty = torch.empty(0, dtype=tables.out_dtype, device=dev)
    M = tables.m_uniform
    if (isinstance(shard_ids, torch.Tensor) and shard_ids.device == dev
            and dev.type == "cuda"):
        sids = shard_ids.reshape(-1)
        if sids.numel() == 0:
            return empty
        if not trusted:
            lo, hi = (int(v) for v in torch.aminmax(sids))
            _validate_sids(np.array([lo, hi]), tables.num_shards)
        sids = sids.to(torch.int32).contiguous()
        with _span("shard.row_keys"):
            rowtab, m_of = row_keys(sids, M is None)
        if M is not None:
            ends, lanes = None, sids.numel() * M
        else:
            ends = torch.cumsum(m_of, 0)
            lanes = int(ends[-1])
    else:
        ids = _host_ids(shard_ids)
        _validate_sids(ids, tables.num_shards)
        if ids.size == 0:
            return empty
        ends, lanes = None, ids.size * (M or 0)
        if M is None:
            ends_np = np.cumsum(tables.sizes[ids])
            lanes = int(ends_np[-1])
            ends = torch.from_numpy(ends_np).to(dev)
        sids = torch.from_numpy(ids.astype(np.int32)).to(dev)
        with _span("shard.row_keys"):
            rowtab, _m = row_keys(sids, False)
    if lanes == 0:
        return empty
    with _span("shard.expand", lanes=lanes):
        return expand(rowtab, sids, ends, lanes)


def _expand_confirmed(shard_ids, shard_sizes, device, *, id_space=None,
                      traced: bool = False, **kw) -> torch.Tensor:
    """``_expand`` of ``shard_ids`` over the tables of ``shard_sizes`` on
    ``device``, launched before the tables are looked up: with the tables
    the last expansion over this ``shard_sizes`` object confirmed
    (``shard.remembered_tables``), then confirmed against every size while
    the card computes (``shard.confirm_tables``).  On a miss the first
    output (or error) is dropped and the expansion launched again with the
    confirmed tables; with nothing remembered the lookup runs first.  Ids
    in ``[0, id_space)`` by construction are trusted when the tables hold
    as many shards.  ``traced`` times the confirmation as the span
    ``shard.tables``, which only the sampler's regen opens."""
    if isinstance(shard_ids, Iterator):
        shard_ids = list(shard_ids)  # a relaunch reads the ids again

    def launch(tables):
        return _expand(shard_ids, tables, trusted=(
            id_space is not None and tables.num_shards >= id_space), **kw)

    def lookup(guess=None):
        with (_span("shard.tables") if traced else NULL_SPAN) as s:
            tables = shard.confirm_tables(shard_sizes, device, guess)
            if guess is not None:
                s.set("hit", tables is guess)
        return tables

    guess = shard.remembered_tables(shard_sizes, device)
    if guess is None:
        return launch(lookup())
    try:
        out = launch(guess)
    except (ValueError, RuntimeError) as exc:
        out = exc  # the guess's: raised only if the lookup confirms it
    tables = lookup(guess)
    if tables is not guess:
        return launch(tables)
    if isinstance(out, Exception):
        raise out
    return out


def expand_shard_indices_generic(
    shard_ids,
    shard_sizes,
    *,
    seed=0,
    epoch=0,
    within_shard_shuffle: Union[bool, int] = True,
    rounds: int = core.DEFAULT_ROUNDS,
) -> torch.Tensor:
    """The expansion by the plain law, every output lane in stream order,
    on the device of a ``shard_ids`` tensor (else the CPU): the kernels'
    plain version.  int32, or int64 when the whole shard space sums past
    2^31."""
    full, w = shuffle_mode(within_shard_shuffle)
    device = (shard_ids.device if isinstance(shard_ids, torch.Tensor)
              else "cpu")
    return _expand_confirmed(shard_ids, shard_sizes, device, seed=seed,
                             epoch=epoch, full=full, w=w, rounds=rounds,
                             plain=True)


def expand_shard_indices_cuda(
    shard_ids,
    shard_sizes,
    *,
    seed=0,
    epoch=0,
    within_shard_shuffle: Union[bool, int] = True,
    rounds: int = core.DEFAULT_ROUNDS,
    device="cuda",
    triple=None,
) -> torch.Tensor:
    """Expand a rank's shard-id stream into global sample indices on
    ``device`` (default: the current CUDA device) — same law, order and
    values as ``expand_shard_indices_cpu``.  ``shard_ids`` is a list, a
    numpy array or an int tensor (a CUDA one stays on the card).  On CUDA
    the kernels ``shard_row_keys`` and ``shard_expand`` run on the current
    stream; ``device="cpu"`` runs their plain version.  int32, or int64
    when the whole shard space (not the selection) sums past 2^31.
    ``triple`` (with ``seed`` and ``epoch`` None) is the seed triple as an
    int32[3] tensor on ``device``."""
    full, w = shuffle_mode(within_shard_shuffle)
    ck.device_kind(device)
    return _expand_confirmed(shard_ids, shard_sizes, device, seed=seed,
                             epoch=epoch, full=full, w=w, rounds=rounds,
                             triple=triple, plain=False)


def expand_shard_indices(
    shard_ids: Sequence[int],
    shard_sizes: Sequence[int],
    *,
    seed: int = 0,
    epoch: int = 0,
    within_shard_shuffle: Union[bool, int] = True,
    rounds: int = core.DEFAULT_ROUNDS,
) -> Iterator[int]:
    """Generator form of :func:`expand_shard_indices_cpu` (same law, same
    order), expanding ``_EXPAND_BLOCK`` shards at a time, so memory stays
    O(block)."""
    sids = np.asarray(list(shard_ids), dtype=np.int64)
    for start in range(0, len(sids), _EXPAND_BLOCK):
        yield from expand_shard_indices_cpu(
            sids[start:start + _EXPAND_BLOCK], shard_sizes, seed=seed,
            epoch=epoch, within_shard_shuffle=within_shard_shuffle,
            rounds=rounds,
        ).tolist()


def shuffle_buffer(
    items: Iterable,
    buffer_size: int,
    *,
    seed: int = 0,
    epoch: int = 0,
) -> Iterator:
    """Deterministic bounded shuffle buffer (SPEC.md §7) — the WebDataset
    ``.shuffle(N)`` stage, reproducible from ``(seed, epoch)``.

    Keeps ``buffer_size`` items; each step evicts the slot ``mix32(key ^
    step) mod fill`` (key = the §1 epoch key xored with 0x51ED270B, then
    mixed) and refills from upstream.  An item appears at most
    ``buffer_size - 1`` positions early; replaying the same ``(seed,
    epoch)`` over the same upstream order reproduces the stream."""
    if buffer_size < 1:
        raise ValueError(f"buffer_size must be >= 1, got {buffer_size}")
    key = core.mix32(core.derive_epoch_key(seed, epoch) ^ 0x51ED270B)
    buf = []
    step = 0
    for item in items:
        buf.append(item)
        if len(buf) < buffer_size:
            continue
        j = core.mix32(key ^ step) % len(buf)
        step = (step + 1) & core._M32
        buf[j], buf[-1] = buf[-1], buf[j]
        yield buf.pop()
    while buf:
        j = core.mix32(key ^ step) % len(buf)
        step = (step + 1) & core._M32
        buf[j], buf[-1] = buf[-1], buf[j]
        yield buf.pop()


class PartialShuffleShardSampler(PartiallyShuffleDistributedSampler):
    """Yields shard ids for this rank, windowed-shuffled per epoch.

    The contract of the sample-level sampler (``window`` defaults to 64
    here): the window bounds how far a shard moves from its stored order,
    keeping reads clustered within a storage prefix.  Checkpoints are the
    JAX package's shard sampler's."""

    def __init__(self, num_shards: int, **kwargs) -> None:
        kwargs.setdefault("window", 64)
        super().__init__(int(num_shards), **kwargs)

    def _shard_ids(self, epoch: int):
        """The epoch's shard ids without touching the ``set_epoch``
        prefetch or the consumption counters: a CUDA tensor regenerated on
        the card (the elastic remainder when ``epoch`` is the one being
        resumed), or the host array on a host backend."""
        if self.backend != "cuda":
            return self._epoch_indices(epoch, consume_prefetch=False)
        if self._elastic is not None and epoch == self.epoch:
            from ..ops.cuda import elastic_indices_cuda

            el = self._elastic
            if el["remaining"] == 0:
                return torch.empty(0, dtype=torch.int32, device="cuda")
            return elastic_indices_cuda(
                self.n, self.window, self.seed, epoch, self.rank,
                self.num_replicas, el["num_samples"], el["chain"],
                shuffle=self.shuffle, order_windows=self.order_windows,
                partition=self.partition, rounds=self.rounds,
            )
        return self._generate_device(epoch)

    def device_epoch_indices(
        self,
        shard_sizes: Sequence[int],
        *,
        epoch: Optional[int] = None,
        within_shard_shuffle: Union[bool, int] = True,
    ) -> torch.Tensor:
        """This rank's expanded global sample indices for ``epoch``
        (default: current): the rank's shard stream expanded with this
        sampler's ``(seed, rounds)``, as a CUDA tensor (a CPU tensor, by
        the plain expansion, on a host backend).  On the cuda backend the
        shard ids never leave the card.  Side-effect free: neither the
        consumption counters nor the ``set_epoch`` prefetch are touched."""
        e = self.epoch if epoch is None else int(epoch)
        full, w = shuffle_mode(within_shard_shuffle)
        device = "cuda" if self.backend == "cuda" else "cpu"
        with _span("psds_shard_regen", n=self.n, world=self.num_replicas,
                   device_ms=device):
            return _expand_confirmed(
                self._shard_ids(e), shard_sizes, device, id_space=self.n,
                traced=True, seed=self.seed, epoch=e, full=full, w=w,
                rounds=self.rounds, plain=False,
            )
