"""Closed-loop epoch regens of one rank's single-source stream.

Epoch e = 0, 1, 2, ... of one rank (drawn from the seed) of ``world``,
each through the port's entry ``ops.cuda.epoch_indices_cuda`` to a
synchronised stream: what a rank pays at each epoch start, and on each
resume, when nothing prefetched it.  Where the configuration names the
rank's model, its training state (``weights.train_state``) lies on the
card beside the regens, as it does in the job.  A seed-drawn sample of the window's
regens is held, lane by lane, against the law's plain reference.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bench_port import weights
from bench_port.counts import law as law_counts
from bench_port.reference import law

#: epochs of the warm-up, apart from those the window runs
WARM_EPOCHS = (0xFFFFFFFF, 0xFFFFFFFE, 0xFFFFFFFD)


def draw_rank(seed: int, world: int) -> int:
    return int(np.random.default_rng(seed).integers(world))


def checked_epochs(seed: int, count: int, below: int) -> set:
    """The first epoch and ``count`` more drawn from the seed below
    ``below`` (every window reaches them; the last is added after it)."""
    rng = np.random.default_rng([seed, 1])
    return {0, *(int(e) for e in rng.integers(1, below, count))}


class Driver:
    def __init__(self, config: dict, params: dict, seed: int, device: str,
                 *, fault=None):
        self.n, self.window_len = config["num_samples"], config["window"]
        self.rounds, self.partition = config["rounds"], config["partition"]
        self.world = params["world"]
        self.params, self.seed, self.device = params, int(seed), device
        self.rank = draw_rank(self.seed, self.world)
        self.fault = fault
        self.model_cfg = config.get("model")
        self.kept = {}
        self.failed = 0
        self.resident = None

    def regen(self, epoch: int) -> torch.Tensor:
        out = self.fn(epoch)
        if self.fault == "altered_answer":  # a fault the checks must catch
            out = out.clone()
            out[out.numel() // 2] += 1
        return out

    def sync(self):
        if self.device != "cpu":
            torch.cuda.synchronize()

    def hold_state(self):
        if self.model_cfg is not None:
            self.resident = weights.train_state(self.model_cfg, self.seed,
                                                self.device)

    def setup(self):
        from partiallyshuffledistributedsampler_tpu_torch.ops.cuda import (
            epoch_indices_cuda,
        )

        self.hold_state()

        def fn(e):
            return epoch_indices_cuda(
                self.n, self.window_len, self.seed, e, self.rank, self.world,
                rounds=self.rounds, partition=self.partition,
                device=self.device)

        self.fn = fn
        for e in WARM_EPOCHS:
            self.regen(e)
            self.sync()

    def _loop(self, seconds: float, limit: int, first: int, keep=()):
        walls, e = [], first
        t0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            out = self.regen(e)
            self.sync()
            b = time.perf_counter()
            walls.append(b - a)
            if e in keep:
                self.kept[e] = out
            e += 1
            if b - t0 >= seconds or e - first >= limit:
                break
        self.kept.setdefault(e - 1, out)
        return walls, b - t0

    def window(self, seconds: float) -> dict:
        keep = checked_epochs(self.seed, self.params["checked_regens"],
                              self.params["checked_below"])
        walls, total = self._loop(seconds, 1 << 62, 0, keep)
        self.next_epoch = len(walls)
        ms = np.asarray(walls) * 1e3
        return dict(attempted=len(walls), walls_ms=ms,
                    metrics=dict(regen_ms=total * 1e3 / len(walls),
                                 regen_p95_ms=float(np.percentile(ms, 95))))

    def traced(self) -> int:
        walls, _ = self._loop(1e9, self.params["traced_regens"],
                              self.next_epoch)
        return len(walls)

    def counts(self) -> dict:
        """The law's work of one regen: by kernel, and the whole regen's
        (``regen``)."""
        work = law_counts.index_amortized(
            self.n, self.window_len, self.world, self.rank, self.rounds)
        return {"index_amortized": work, "regen": work}

    def release(self):
        self.fn = self.resident = None

    def reference(self, epoch: int, device, rounds=None) -> torch.Tensor:
        """The regen by the plain reference (at ``rounds``: the control)."""
        return law.epoch_indices(
            self.n, self.window_len, self.seed, epoch, self.rank, self.world,
            rounds=rounds or self.rounds, partition=self.partition,
            device=device)

    def checks(self) -> list:
        """Lanes of the held regens that differ from the reference law
        (exact: the law is integer arithmetic)."""
        bad, wrong = 0, 0
        for e, got in sorted(self.kept.items()):
            want = self.reference(e, got.device)
            diff = (int((got.long() != want).sum()) if got.shape == want.shape
                    else want.numel())
            bad += diff
            wrong += diff > 0
        self.failed = wrong
        return [("mismatched_lanes", bad, 0)]
