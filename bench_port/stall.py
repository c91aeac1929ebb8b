"""The DataLoader stall probe of BASELINE.json's "DataLoader stall %": a
copy of the port's ``utils/stall_probe.StallProbe``, so that the
benchmark's definition stays fixed whatever the program does with its own.

The stall is the share of the loop's wall spent waiting for the next
batch: wait / (wait + compute), where the wait is the time inside the
upstream ``__next__`` and the compute is the time between a batch's yield
and the next request.  A consumer on the card that never waits for its
own kernels counts only their launch as compute.
"""

from __future__ import annotations

import time


class StallProbe:
    def __init__(self, inner):
        self._inner = inner
        self.wait_s = 0.0
        self.compute_s = 0.0
        self.batches = 0

    @property
    def stall_fraction(self) -> float:
        total = self.wait_s + self.compute_s
        return self.wait_s / total if total > 0 else 0.0

    def __iter__(self):
        it = iter(self._inner)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            self.wait_s += time.perf_counter() - t0
            self.batches += 1
            # resumed when the consumer asks for the next item, or closed
            # (GeneratorExit at the yield) when it stops: either ends the
            # consumer's compute for this batch
            t_yield = time.perf_counter()
            try:
                yield item
            except GeneratorExit:
                self.compute_s += time.perf_counter() - t_yield
                raise
            self.compute_s += time.perf_counter() - t_yield
