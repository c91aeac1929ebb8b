"""BASELINE config 1's shape: a CIFAR-10-sized dataset, DDP over 2 ranks,
window 512 — the reference's canonical usage, unchanged but for the
sampler class, built with ``backend="auto"``.

A real DDP launch (one process per rank; the sampler's identity comes from
the process group, as with torch's own ``DistributedSampler``):

    torchrun --nproc_per_node=2 -m \
        partiallyshuffledistributedsampler_tpu_torch.examples.torch_ddp

One process, the ranks one after the other:

    python -m partiallyshuffledistributedsampler_tpu_torch.examples.torch_ddp

The model trains on the card; ``--cpu`` keeps everything on the host.
The dataset is a synthetic 50,000-sample tensor dataset made from a seed,
so nothing is downloaded.
"""

from __future__ import annotations

import os
import time

import torch
from torch.utils.data import DataLoader, TensorDataset

from .. import PartiallyShuffleDistributedSampler, StallProbe
from .common import parse_device

N, WORLD, WINDOW, BATCH, EPOCHS = 50_000, 2, 512, 256, 2


def run_rank(rank: int, device: str, ddp: bool = False) -> list:
    """Train ``EPOCHS`` epochs as ``rank``; returns the rank's sample ids
    of the last epoch."""
    torch.manual_seed(0)  # the same synthetic data on every rank
    data = TensorDataset(torch.randn(N, 3 * 32 * 32),
                         torch.randint(0, 10, (N,)), torch.arange(N))
    model = torch.nn.Sequential(
        torch.nn.Linear(3 * 32 * 32, 64), torch.nn.ReLU(),
        torch.nn.Linear(64, 10)).to(device)
    if ddp:
        model = torch.nn.parallel.DistributedDataParallel(model)
        # the identity comes from the process group: the call a torch
        # DistributedSampler user writes, with the class swapped
        sampler = PartiallyShuffleDistributedSampler(data, window=WINDOW,
                                                     backend="auto")
    else:
        sampler = PartiallyShuffleDistributedSampler(
            data, num_replicas=WORLD, rank=rank, window=WINDOW,
            backend="auto")
    opt = torch.optim.SGD(model.parameters(), lr=0.01)
    loader = DataLoader(data, batch_size=BATCH, sampler=sampler,
                        num_workers=0, pin_memory=device == "cuda")
    for epoch in range(EPOCHS):
        sampler.set_epoch(epoch)  # the regen is launched here
        probe = StallProbe(loader)
        seen = []
        t0 = time.perf_counter()
        for x, y, ids in probe:
            x, y = x.to(device, non_blocking=True), y.to(device,
                                                          non_blocking=True)
            loss = torch.nn.functional.cross_entropy(model(x), y)
            opt.zero_grad()
            loss.backward()
            opt.step()
            seen.append(ids)
        # raw_wait counts the DataLoader's collation as "wait" too
        print(f"rank {rank} epoch {epoch}: "
              f"{time.perf_counter() - t0:.2f} s, loss {loss.item():.3f}, "
              f"raw_wait {probe.report()['stall_pct']}%, regen "
              f"{sampler.regen_timer.last_ms:.2f} ms "
              f"[backend={sampler.backend}, device={device}]")
    return torch.cat(seen).tolist()


def main(argv=None) -> None:
    device = parse_device(__doc__.splitlines()[0], argv)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:  # torchrun
        import torch.distributed as dist

        if device == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if device == "cuda" else "gloo")
        try:
            run_rank(dist.get_rank(), device, ddp=True)
        finally:
            dist.destroy_process_group()
        return
    shards = [run_rank(r, device) for r in range(WORLD)]
    assert all(len(s) == N // WORLD for s in shards)
    assert sorted(shards[0] + shards[1]) == list(range(N))
    print(f"ok: {WORLD} ranks, {EPOCHS} epochs each through a DataLoader; "
          f"the last epoch's shards tile all {N} samples once")


if __name__ == "__main__":
    main()
