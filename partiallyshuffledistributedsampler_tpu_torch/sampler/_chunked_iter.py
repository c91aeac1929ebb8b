"""Shared torch-surface iteration machinery (single home).

Every torch-facing sampler of this package (`PartiallyShuffleDistributedSampler`
today) iterates the same way: claim the consumed
counter with a generation token, regenerate the epoch's indices, resume
from `_offset`, and stream python ints in bounded chunks.  The logic is
subtle in two ways that must never diverge between the samplers — which
is why it lives once here:

* **Generation ownership**: any later ``__iter__``, ``set_epoch`` or
  ``load_state_dict`` bumps ``_generation``, so a generator still
  draining from before (the DataLoader prefetch pattern, a second live
  iterator, a same-epoch state load with a different offset) can never
  write a stale count into the next checkpoint.
* **Chunked int-boxing**: indices convert via one small ``tolist`` per
  ``STREAM_CHUNK`` so the first batch is dispatchable ~immediately
  instead of after a full O(num_samples) conversion (360 ms at 1e7 per
  BASELINE.md) — the epoch-boundary stall the on-device regen removed
  must not sneak back in through host-side conversion (SURVEY.md §7
  hard part 3).

Host classes provide: ``epoch_indices()`` (the epoch's index array),
``_offset``, ``_consumed``, ``_generation``.
"""

from __future__ import annotations

from typing import Iterator


class ChunkedIterMixin:
    #: indices are converted to python ints in chunks of this size
    STREAM_CHUNK = 65536

    def __iter__(self) -> Iterator[int]:
        self._generation += 1
        gen = self._generation
        indices = self.epoch_indices()
        start = self._offset
        self._offset = 0  # a fresh epoch starts at 0 unless state is loaded
        self._consumed = start
        chunk = self.STREAM_CHUNK
        n_total = indices.shape[0]
        for cs in range(start, n_total, chunk):
            # one small tolist per chunk: any device->host transfer was
            # already async (set_epoch); the only per-chunk cost is boxing
            for i in indices[cs:min(cs + chunk, n_total)].tolist():
                if self._generation == gen:
                    self._consumed += 1
                yield i
