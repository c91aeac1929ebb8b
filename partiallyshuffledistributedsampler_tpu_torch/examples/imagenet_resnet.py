"""BASELINE config 2's shape: ImageNet-1k, window 8192, 8 ranks.

    python -m partiallyshuffledistributedsampler_tpu_torch.examples.imagenet_resnet

Three tiers:

1. The real index space (n = 1,281,167) partially shuffled with window
   8192 across 8 ranks, 8 samplers in one process (``backend="auto"``):
   the DDP partition invariant, and the read locality the windowed
   shuffle sells (every 8192-aligned block of the global stream draws from
   exactly one source window).
2. A residual conv net (a ResNet stand-in) on synthetic 32x32 images
   through ``StatefulDataLoader``, with a mid-epoch checkpoint that
   resumes exactly.
3. The ViT consumer (config 4's ViT-L/16, pocket-sized) through
   ``models.demo_vit_run``: the regen and every step's gather on the card.

Everything runs on the card; ``--cpu`` runs it on the host.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.data import TensorDataset

from .. import (
    PartiallyShuffleDistributedSampler,
    StatefulDataLoader,
    parallel,
)
from ..models import ViTConfig, demo_vit_run
from .common import parse_device, process_group

IMAGENET_N = 1_281_167  # the ImageNet-1k train split
WINDOW = 8192
WORLD = 8


def real_scale_index_tier() -> None:
    samplers = [PartiallyShuffleDistributedSampler(
        IMAGENET_N, num_replicas=WORLD, rank=r, window=WINDOW, seed=17,
        backend="auto") for r in range(WORLD)]
    for s in samplers:
        s.set_epoch(1)
    t0 = time.perf_counter()
    shards = [s.epoch_indices() for s in samplers]
    regen_ms = (time.perf_counter() - t0) * 1e3
    num_samples = len(samplers[0])
    assert all(len(sh) == num_samples for sh in shards)
    union = np.concatenate(shards)
    assert len(np.unique(union)) == IMAGENET_N  # every sample served
    # the strided shards reinterleaved into the global stream: every full
    # 8192-aligned block draws from one source window (SPEC.md §3)
    stream = np.empty(num_samples * WORLD, dtype=union.dtype)
    for r, sh in enumerate(shards):
        stream[r::WORLD] = sh
    full = IMAGENET_N // WINDOW * WINDOW
    src = stream[:full].reshape(-1, WINDOW) // WINDOW
    assert (src == src[:, :1]).all(), "window locality broken"
    print(f"ok: tier 1, n={IMAGENET_N:,} window={WINDOW} world={WORLD} "
          f"[backend={samplers[0].backend}]: partition and window locality "
          f"hold ({full // WINDOW} full windows), all-rank regen "
          f"{regen_ms:.1f} ms")


class TinyResNet(nn.Module):
    """A residual conv block and a classifier: ResNet-50's shape, pocket
    size."""

    def __init__(self):
        super().__init__()
        self.stem = nn.Conv2d(3, 16, 3, padding=1)
        self.c1 = nn.Conv2d(16, 16, 3, padding=1)
        self.c2 = nn.Conv2d(16, 16, 3, padding=1)
        self.head = nn.Linear(16, 10)

    def forward(self, x):
        x = F.relu(self.stem(x))
        x = F.relu(x + self.c2(F.relu(self.c1(x))))  # residual block
        return self.head(x.mean(dim=(2, 3)))


def training_slice_tier(device: str) -> None:
    torch.manual_seed(0)
    n, batch = 2048, 64
    ds = TensorDataset(torch.randn(n, 3, 32, 32), torch.randint(0, 10, (n,)))
    backend = "cpu" if device == "cpu" else "cuda"

    def make():
        s = PartiallyShuffleDistributedSampler(ds, num_replicas=2, rank=0,
                                               window=256, backend=backend)
        return s, StatefulDataLoader(ds, batch_size=batch, sampler=s,
                                     num_workers=0)

    def train(model, opt, xb, yb):
        loss = F.cross_entropy(model(xb.to(device)), yb.to(device))
        opt.zero_grad()
        loss.backward()
        opt.step()
        return loss

    # train, checkpoint mid-epoch, and finish the epoch in a "restarted
    # process" (a fresh sampler, loader and model from the checkpoint)
    model = TinyResNet().to(device)
    opt = torch.optim.SGD(model.parameters(), lr=0.05)
    sampler, loader = make()
    sampler.set_epoch(0)
    for step, (xb, yb) in enumerate(loader):
        train(model, opt, xb, yb)
        if step == 7:
            state = {"loader": loader.state_dict(),
                     "model": model.state_dict()}
            break
    model2 = TinyResNet().to(device)
    model2.load_state_dict(state["model"])
    opt2 = torch.optim.SGD(model2.parameters(), lr=0.05)
    sampler2, loader2 = make()
    loader2.load_state_dict(state["loader"])
    expect = -(-len(sampler2) // batch)  # len counts from the resumed offset
    steps, last = 0, None
    for xb, yb in loader2:
        last = train(model2, opt2, xb, yb)
        steps += 1
    assert steps == expect, (steps, expect)
    print(f"ok: tier 2, trained 8 steps, checkpointed mid-epoch, resumed "
          f"the {steps} remaining steps exactly; final loss "
          f"{last.item():.3f} [backend={backend}]")


def vit_tier(device: str) -> None:
    with process_group(device):
        mesh = parallel.data_mesh(device=device)
        cfg = ViTConfig(image_size=16, patch_size=4, d_model=64, n_layers=1,
                        n_heads=2, d_ff=128, num_classes=8)
        losses = demo_vit_run(mesh, cfg, n_samples=32, window=16,
                              batch_per_dp=8, steps_per_epoch=4, epochs=5)
    means = np.asarray(losses).reshape(5, 4).mean(axis=1)
    assert np.isfinite(means).all() and means[-1] < means[0], means
    print(f"ok: tier 3, ViT on the data mesh ({device}): epoch mean loss "
          f"{means[0]:.3f} -> {means[-1]:.3f}, indices never left the "
          f"{device}")


def main(argv=None) -> None:
    device = parse_device(__doc__.splitlines()[0], argv)
    real_scale_index_tier()
    training_slice_tier(device)
    vit_tier(device)
    print("ok: config-2 shape end to end")


if __name__ == "__main__":
    main()
