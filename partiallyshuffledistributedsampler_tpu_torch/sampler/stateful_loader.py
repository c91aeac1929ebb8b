"""Exact mid-epoch checkpointing through a multi-worker ``DataLoader``.

The sampler's auto-tracked consumption counter counts indices *yielded* by
``__iter__``; a multi-worker ``DataLoader`` prefetches
``prefetch_factor * num_workers`` batches ahead of the batches it delivers,
so a bare ``sampler.state_dict()`` taken mid-epoch over-counts by up to that
much (the ``.. warning::`` on
:class:`~partiallyshuffledistributedsampler_tpu_torch.sampler.torch_shim.PartiallyShuffleDistributedSampler`).
torchdata solves this with ``StatefulDataLoader``; torchdata is not a
dependency of this framework, so :class:`StatefulDataLoader` here closes the
same gap natively: it counts **batches handed to the training loop in the
main process** — prefetch depth is invisible to that count by construction —
and converts the count to an exact sample offset when asked for state.

Exactness law (tested in ``tests/test_stateful_loader.py``): for any stop
point k, resuming a fresh loader from ``state_dict()`` taken after batch k
yields exactly the batches k+1.. that the uninterrupted run would have
yielded — same values, same batch boundaries — for any ``num_workers``,
``drop_last``, tail-batch shape, and across ``set_epoch`` boundaries.  The
offset arithmetic relies on delivered batches being contiguous
``samples_per_batch``-sized slices of the sampler stream, which is exactly
the ``BatchSampler`` contract (``torch/utils/data/sampler.py`` [T]); a
custom ``batch_sampler`` with variable batch sizes is rejected at
``state_dict()`` time unless ``samples_per_batch`` is given.
"""

from __future__ import annotations

from typing import Optional

try:
    from torch.utils.data import DataLoader as _TorchDataLoader

    _HAVE_TORCH = True
except Exception:  # torch is an optional dependency of this framework
    _TorchDataLoader = object
    _HAVE_TORCH = False


class StatefulDataLoader(_TorchDataLoader):
    """``torch.utils.data.DataLoader`` with exact ``state_dict()`` mid-epoch.

    Use exactly like ``DataLoader`` with a
    ``PartiallyShuffleDistributedSampler`` (or any sampler exposing this
    library's ``state_dict(consumed=...)`` / ``load_state_dict``) as
    ``sampler=`` — or inside a ``BatchSampler`` as ``batch_sampler=``::

        loader = StatefulDataLoader(ds, batch_size=64, sampler=sampler,
                                    num_workers=4)
        for step, batch in enumerate(loader):
            train(batch)
            ckpt = loader.state_dict()        # exact: counts delivered batches

        # later / elsewhere
        loader.load_state_dict(ckpt)          # resumes at batch step+1

    ``state_dict()`` returns ``{"sampler": <sampler state with the exact
    offset>, "batches_delivered": k}``; ``load_state_dict`` also accepts a
    bare sampler state dict.  The sampler object itself is shared state: the
    loader snapshots/loads *through* it, so checkpointing the sampler
    separately is unnecessary (and, with ``num_workers > 0``, wrong).

    samples_per_batch: only needed with a custom ``batch_sampler`` that does
        not expose ``batch_size``; fixed number of sampler indices per
        delivered batch.
    """

    def __init__(self, *args, samples_per_batch: Optional[int] = None,
                 **kwargs) -> None:
        if not _HAVE_TORCH:
            raise RuntimeError(
                "StatefulDataLoader requires torch; install torch or use "
                "the device-resident DeviceEpochIterator (whose state is exact "
                "without a wrapper)"
            )
        super().__init__(*args, **kwargs)
        self._samples_per_batch_override = (
            int(samples_per_batch) if samples_per_batch is not None else None
        )
        s = self._stateful_sampler()  # validate construction eagerly
        for m in ("state_dict", "load_state_dict"):
            if not callable(getattr(s, m, None)):
                raise TypeError(
                    f"sampler {type(s).__name__} has no {m}(); "
                    "StatefulDataLoader needs this library's sampler "
                    "checkpoint surface (torch_shim.py)"
                )
        if not hasattr(s, "_offset"):
            # the offset a NEW __iter__ will start from is not derivable
            # from the public state (state_dict()['offset'] reports the
            # consumed count, which diverges from the restart position when
            # an epoch is re-iterated) — require the real attribute rather
            # than silently assuming 0 and double-training resumed samples
            raise TypeError(
                f"sampler {type(s).__name__} has no _offset; "
                "StatefulDataLoader supports "
                "PartiallyShuffleDistributedSampler-compatible samplers"
            )
        self._samples_per_batch()  # fail at construction, not mid-training
        #: None until an epoch iterator is created; then the count of batches
        #: the training loop has received from the CURRENT epoch iterator
        self._batches_delivered: Optional[int] = None
        self._epoch_offset = 0  # sampler offset when the epoch iter started
        self._epoch_len = 0  # sampler indices this epoch iter will yield
        self._iter_generation = 0  # ownership token: which iterator counts
        self._epoch_token = None  # sampler (epoch, seed) the count describes
        self._sampler_gen = None  # sampler _generation at epoch-iter start

    # ------------------------------------------------------------- plumbing
    def _stateful_sampler(self):
        """The checkpointable sampler, wherever this loader holds it."""
        if self.batch_sampler is not None:
            inner = getattr(self.batch_sampler, "sampler", None)
            if inner is not None and hasattr(inner, "state_dict"):
                return inner
        if self.sampler is not None and hasattr(self.sampler, "state_dict"):
            return self.sampler
        raise TypeError(
            "no checkpointable sampler found: pass a "
            "PartiallyShuffleDistributedSampler as sampler= (or inside "
            "batch_sampler=)"
        )

    def _samples_per_batch(self) -> int:
        if self._samples_per_batch_override is not None:
            return self._samples_per_batch_override
        if self.batch_size is not None:  # ordinary batch_size= construction
            return int(self.batch_size)
        if self.batch_sampler is not None:  # custom batch_sampler=
            bs = getattr(self.batch_sampler, "batch_size", None)
            if bs is not None:
                return int(bs)
            raise TypeError(
                f"batch_sampler {type(self.batch_sampler).__name__} exposes "
                "no batch_size; pass samples_per_batch= to "
                "StatefulDataLoader (state_dict needs the fixed "
                "indices-per-batch count to convert batches to an offset)"
            )
        return 1  # batch_size=None sample mode: one index per item

    # ------------------------------------------------------------ iteration
    def __iter__(self):
        s = self._stateful_sampler()
        # snapshot BEFORE the base iterator touches the sampler: creating a
        # worker iterator immediately prefetches, which resets the sampler's
        # offset and races its auto-count ahead
        self._epoch_offset = int(s._offset)
        self._epoch_len = len(s)
        self._batches_delivered = 0
        # claim the counter for THIS iterator (mirror of the sampler's own
        # _generation guard, torch_shim.py): a stale iterator drained after
        # a newer __iter__ or load_state_dict must not count
        self._iter_generation += 1
        my_gen = self._iter_generation
        # the count describes this sampler position; set_epoch to a new
        # epoch (or a seed change) makes it describe a stream the sampler
        # no longer serves — state_dict detects that via this token
        self._epoch_token = (int(getattr(s, "epoch", 0)),
                             int(getattr(s, "seed", 0)))
        # the sampler bumps its own _generation on every __iter__/set_epoch/
        # load_state_dict; from this snapshot, normal iteration advances it
        # by exactly one (our single underlying sampler iter) — any further
        # advance means someone moved the sampler underneath this count
        self._sampler_gen = getattr(s, "_generation", None)
        for batch in super().__iter__():
            # count first: a checkpoint taken in the loop body for batch k
            # must include batch k as delivered
            if self._iter_generation == my_gen:
                self._batches_delivered += 1
            yield batch

    def _delivered_samples(self) -> int:
        """Sampler indices consumed by the batches delivered so far this
        epoch (tail batch may be short: cap at the epoch's stream length)."""
        return min(
            self._batches_delivered * self._samples_per_batch(),
            self._epoch_len,
        )

    # ----------------------------------------------------- checkpoint state
    def state_dict(self) -> dict:
        s = self._stateful_sampler()
        stale = (
            self._batches_delivered is None
            # sampler moved on (set_epoch to a new epoch / state load with a
            # different seed): the batch count describes the OLD stream and
            # converting it to an offset would skip never-trained samples of
            # the new one; the sampler reset its own counters at that move,
            # so its bare state is the exact answer
            or self._epoch_token != (int(getattr(s, "epoch", 0)),
                                     int(getattr(s, "seed", 0)))
            # same-epoch sampler moves (a direct sampler.load_state_dict)
            # advance the sampler's generation past the one bump our own
            # underlying iterator accounts for
            or (self._sampler_gen is not None
                and getattr(s, "_generation", self._sampler_gen)
                - self._sampler_gen > 1)
        )
        if stale:
            return {"sampler": s.state_dict(), "batches_delivered": 0}
        consumed = self._epoch_offset + self._delivered_samples()
        return {
            "sampler": s.state_dict(consumed=consumed),
            "batches_delivered": int(self._batches_delivered),
        }

    def load_state_dict(self, state: dict) -> None:
        s = self._stateful_sampler()
        s.load_state_dict(state.get("sampler", state))
        # counting restarts when the resumed epoch's iterator is created;
        # bump the ownership token so an old iterator still draining can
        # neither count nor crash on the cleared counter
        self._iter_generation += 1
        self._batches_delivered = None
