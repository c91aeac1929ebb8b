"""DataLoader stall probe — instrumentation for the metric "DataLoader
stall %" (BASELINE.json).

The stall metric is the fraction of wall-clock time the training loop
spends *waiting for the next batch* rather than computing.  The probe wraps
any iterable; the loop's compute is the gap between ``__next__`` returning
and the next call.

    probe = StallProbe(loader.epoch(e))
    for batch in probe:
        train_step(batch)          # any work between nexts counts as compute
    print(probe.stall_fraction)

A consumer on the card that never waits for its own kernels counts only
their launch as compute; the probe measures what the host sees.
"""

from __future__ import annotations

import time
from typing import Iterable, Iterator


class StallProbe:
    """Wraps an iterable and measures producer-wait vs consumer-compute time.

    ``wait_s``    — total time blocked inside the upstream ``__next__``.
    ``compute_s`` — total time between yielding a batch and being asked for
                    the next one (the consumer's step time).
    ``stall_fraction`` — wait / (wait + compute); 0.0 = never starved.
    """

    def __init__(self, inner: Iterable):
        self._inner = inner
        self.reset()

    def reset(self) -> None:
        self.wait_s = 0.0
        self.compute_s = 0.0
        self.batches = 0

    @property
    def stall_fraction(self) -> float:
        total = self.wait_s + self.compute_s
        return self.wait_s / total if total > 0 else 0.0

    def __iter__(self) -> Iterator:
        it = iter(self._inner)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            self.wait_s += time.perf_counter() - t0
            self.batches += 1
            # the generator suspends at yield and resumes when the consumer
            # asks for the next item — so (resume - t_yield) IS the
            # consumer's compute time for this batch.  A consumer that
            # `break`s out never resumes normally; CPython closes the
            # abandoned generator at the break (GeneratorExit lands at the
            # yield), which is the moment the last batch's compute ends.
            t_yield = time.perf_counter()
            try:
                yield item
            except GeneratorExit:
                self.compute_s += time.perf_counter() - t_yield
                raise
            self.compute_s += time.perf_counter() - t_yield

    def report(self) -> dict:
        return {
            "batches": self.batches,
            "wait_s": round(self.wait_s, 6),
            "compute_s": round(self.compute_s, 6),
            "stall_pct": round(100.0 * self.stall_fraction, 3),
        }
