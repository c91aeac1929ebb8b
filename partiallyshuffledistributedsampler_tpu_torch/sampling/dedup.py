"""Seen-set dedup filtering: deterministic, checkpointable, fail-safe.

The dedup stream wraps the weighted draw with a seeded seen-set fold:
epoch ``e``'s global stream walks draw ordinals ``p = 0..T-1`` in order,
re-drawing any sample the set already holds (a bounded per-ordinal retry
chain, then a linear probe over the id space), and adds every served id.
The fold is a pure function of ``(spec, epoch)`` given the epoch-start
state, so the epoch-boundary state is derivable by refolding epochs
``0..e-1`` from scratch; a snapshot only makes recovery O(T).  The JAX
package's fold (its ``sampling/dedup.py``), step for step: the same state
and the same candidates give the same stream and the same end state.

Two seen-set kinds:

* ``exact``: a plain id set, zero false positives;
* ``bloom``: a seeded Bloom filter, no false negatives (a served sample is
  always recognised), a fixed bit budget; a false positive only costs an
  extra re-draw.

The fault site ``sampling.dedup_check`` wraps every membership test of a
candidate draw.  A firing rule makes the check *fail safe*: the candidate
is treated as seen and re-drawn, so an injected fault can delay a sample
but can never double-serve one.

The candidates, one row per retry round, come from the weighted kernel:
on ``backend="cuda"`` one ``weighted_stream`` launch a round over the
ordinals, read back once; the sequential fold is host Python, the
normative law.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from .. import faults as F
from .. import telemetry
from ..ops import core, ensure_index_backend, host_array
from .alias import AliasTable, kernel_for, weighted_stream_at_generic

__all__ = [
    "ExactSeen", "BloomSeen", "make_seen", "restore_seen",
    "dedup_check", "fold_epoch", "fold_candidates",
]

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_C_BLOOM = 0x2545F491


def _pymix(x: int) -> int:
    """murmur3 fmix32 on a Python int: the host-side twin of ``core.mix32``
    for the Bloom hash family (the fold walks ordinals one at a time)."""
    x &= _M32
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & _M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & _M32
    x ^= x >> 16
    return x


class ExactSeen:
    """The exact seen-set: a plain id set with a JSON-safe snapshot."""

    kind = "exact"

    def __init__(self, ids=()) -> None:
        self._ids = set(int(x) for x in ids)

    def __len__(self) -> int:
        return len(self._ids)

    def contains(self, x: int) -> bool:
        return int(x) in self._ids

    def add(self, x: int) -> None:
        self._ids.add(int(x))

    def copy(self) -> "ExactSeen":
        return ExactSeen(self._ids)

    def snapshot(self) -> dict:
        return {"kind": "exact", "ids": sorted(self._ids)}


class BloomSeen:
    """A seeded Bloom filter seen-set.

    ``bits`` is the filter width in bits, ``hashes`` the probe positions
    per id; both ride the spec wire form.  The hash family is seeded from
    the spec seed, so snapshot and refold agree bit for bit."""

    kind = "bloom"

    def __init__(self, bits: int, hashes: int, seed: int,
                 data: Optional[bytes] = None) -> None:
        bits = int(bits)
        hashes = int(hashes)
        if bits < 8:
            raise ValueError(f"bloom bits must be >= 8, got {bits}")
        if hashes < 1:
            raise ValueError(f"bloom hashes must be >= 1, got {hashes}")
        self.bits, self.hashes = bits, hashes
        self.seed = int(seed) & _M32
        nbytes = (bits + 7) // 8
        if data is None:
            self._data = bytearray(nbytes)
        else:
            data = bytes(data)
            if len(data) != nbytes:
                raise ValueError(
                    f"bloom snapshot holds {len(data)} bytes for a "
                    f"{bits}-bit filter ({nbytes} expected)")
            self._data = bytearray(data)

    def _positions(self, x: int):
        lo, hi = int(x) & _M32, (int(x) >> 32) & _M32
        h = _pymix(lo ^ _pymix(hi ^ _pymix(self.seed ^ _C_BLOOM)))
        for i in range(self.hashes):
            h = _pymix(h ^ ((i * _GOLDEN) & _M32))
            yield h % self.bits

    def contains(self, x: int) -> bool:
        return all(self._data[p >> 3] & (1 << (p & 7))
                   for p in self._positions(x))

    def add(self, x: int) -> None:
        for p in self._positions(x):
            self._data[p >> 3] |= 1 << (p & 7)

    def copy(self) -> "BloomSeen":
        return BloomSeen(self.bits, self.hashes, self.seed,
                         data=bytes(self._data))

    def snapshot(self) -> dict:
        return {"kind": "bloom", "bits": self.bits,
                "hashes": self.hashes, "data": bytes(self._data).hex()}


def make_seen(cfg: dict, seed) -> object:
    """A fresh seen-set from a spec's normalized dedup config."""
    kind = cfg.get("kind", "exact")
    if kind == "exact":
        return ExactSeen()
    if kind == "bloom":
        return BloomSeen(cfg["bits"], cfg["hashes"],
                         core.fold_seed(seed)[0])
    raise ValueError(f"dedup kind must be 'exact' or 'bloom', "
                     f"got {kind!r}")


def restore_seen(wire: dict, seed) -> object:
    """Rebuild a seen-set from its :meth:`snapshot` wire form."""
    kind = wire.get("kind")
    if kind == "exact":
        return ExactSeen(wire.get("ids") or ())
    if kind == "bloom":
        return BloomSeen(wire["bits"], wire["hashes"],
                         core.fold_seed(seed)[0],
                         data=bytes.fromhex(wire["data"]))
    raise ValueError(f"unknown seen-set snapshot kind {kind!r}")


def dedup_check(seen, x: int) -> bool:
    """Membership test for a candidate draw, routed through the
    ``sampling.dedup_check`` fault site.  An injected fault degrades to
    *seen* — the fail-safe direction: the candidate is re-drawn rather
    than risked as a double-serve."""
    try:
        F.fire("sampling.dedup_check")
    except F.InjectedThreadDeath:
        raise
    except Exception as exc:  # lint: allow-broad-except(injected dedup fault degrades to the fail-safe 'seen' verdict)
        telemetry.event("sampling_dedup_failsafe", detail=repr(exc))
        return True
    return seen.contains(int(x))


def fold_candidates(table: AliasTable, source_sizes, seed, epoch: int,
                    epoch_samples: int, *, window: int, shuffle: bool = True,
                    rounds: int = core.DEFAULT_ROUNDS, retries: int = 4,
                    backend: str = "cuda") -> np.ndarray:
    """The fold's candidate rows, ``[retries + 1, T]`` on the host: row
    ``r`` is the weighted draw of every ordinal ``0..T-1`` under retry
    round ``r``.  On 'cuda' one ``weighted_stream(_wide)`` launch a round
    (the ordinals computed in the kernel), read back once; on 'cpu' the
    plain law."""
    ensure_index_backend(backend)
    T = int(epoch_samples)
    kw = dict(window=int(window), shuffle=bool(shuffle), rounds=int(rounds))
    retries = max(0, int(retries))
    if backend == "cuda":
        launch = kernel_for(T)
        rows = [launch(table, source_sizes, seed, epoch, epoch_samples=T,
                       rank=0, world=1, num_samples=T, retry=r, **kw)
                for r in range(retries + 1)]
        return host_array(torch.stack(rows))
    ords = torch.arange(T, dtype=torch.int64)
    return torch.stack([
        weighted_stream_at_generic(ords, table, source_sizes, seed, epoch,
                                   retry=r, **kw)
        for r in range(retries + 1)]).numpy()


def fold_epoch(
    table: AliasTable,
    source_sizes,
    seed,
    epoch: int,
    epoch_samples: int,
    seen,
    *,
    window: int,
    shuffle: bool = True,
    rounds: int = core.DEFAULT_ROUNDS,
    retries: int = 4,
    backend: str = "cuda",
) -> np.ndarray:
    """One epoch of the dedup fold: the global filtered stream of
    ``epoch_samples`` ids, with ``seen`` mutated to the epoch-end state.

    A candidate is a pure function of (ordinal, retry round), so every
    round's candidates come up front (``fold_candidates``); collisions
    walk them in order, then fall back to a linear probe over the id
    space.  When the probe wraps (every id already served) the epoch
    keeps its length and serves the base draw again: saturation is
    reported with a ``RuntimeWarning``."""
    T = int(epoch_samples)
    sizes = tuple(int(n) for n in source_sizes)
    total_n = sum(sizes)
    retries = max(0, int(retries))
    cand = fold_candidates(table, sizes, seed, epoch, T, window=window,
                           shuffle=shuffle, rounds=rounds, retries=retries,
                           backend=backend)
    out = np.empty(T, dtype=cand.dtype)
    saturated = 0
    for p in range(T):
        x = int(cand[0, p])
        r = 0
        while dedup_check(seen, x):
            r += 1
            if r <= retries:
                x = int(cand[r, p])
                continue
            # retry chain exhausted: deterministic linear probe from the
            # last candidate; a full wrap means the id space is saturated
            start = x
            x = (x + 1) % total_n
            while x != start and dedup_check(seen, x):
                x = (x + 1) % total_n
            if x == start:
                saturated += 1
            break
        seen.add(x)
        out[p] = x
    if saturated:
        telemetry.event("sampling_dedup_saturated", epoch=int(epoch),
                        draws=int(saturated))
        warnings.warn(
            f"dedup id space saturated for {saturated} draw(s) in epoch "
            f"{int(epoch)}: every id was already served; repeats are "
            f"unavoidable at this epoch budget", RuntimeWarning,
            stacklevel=2)
    return out
