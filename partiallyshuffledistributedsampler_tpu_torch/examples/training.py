"""Training from device-resident indices (BASELINE config 3's shape: token
rows and a GPT, pocket-sized): the indices are generated on the card and
consumed there.

    python -m partiallyshuffledistributedsampler_tpu_torch.examples.training

Four parts: the whole-run runner over the data mesh (a process group of
one here, or the group ``torchrun`` made), ``DeviceEpochIterator.run_epoch``,
``HostDataLoader`` over host-resident rows, and the mixture run runner
over a concatenated three-corpus id space.  ``--cpu`` runs it all on the
host.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import (
    DeviceEpochIterator,
    HostDataLoader,
    MixtureSpec,
    parallel,
)
from ..models import (
    GPTConfig,
    create_state,
    make_mixture_run_runner,
    make_run_runner,
)
from ..models.train import synthetic_tokens
from .common import parse_device, process_group


def epoch_means(losses: torch.Tensor) -> np.ndarray:
    return losses.float().mean(dim=1).cpu().numpy()


def main(argv=None) -> None:
    device = parse_device(__doc__.splitlines()[0], argv)
    with process_group(device):
        mesh = parallel.data_mesh(device=device)
        world, rank = parallel.identity_from_mesh(mesh)
        print(f"data mesh: world {world} on {device}")

        # 1. the whole run: each epoch's regen on the card (seed agreed
        #    over the mesh), every step's batch gathered there
        cfg = GPTConfig()
        n, window, batch, steps, epochs = 2048, 256, 8, 8, 3
        tokens = synthetic_tokens(cfg, n, 1, device)
        model, opt = create_state(cfg, mesh, seed=0)
        run = make_run_runner(cfg, opt, mesh, batch, steps, epochs, n,
                              window)
        losses = run(model, tokens,
                     parallel.make_seed_triple(0, 0, mesh=mesh), 0)
        means = epoch_means(losses)
        assert losses.shape == (epochs, steps)
        assert np.isfinite(means).all() and means[-1] < means[0], means
        print(f"ok: run runner trained {epochs} x {steps} steps, epoch mean "
              f"loss {means[0]:.3f} -> {means[-1]:.3f}; indices never left "
              f"the {device}")

        # 2. one epoch of steps over the iterator's batch views
        it = DeviceEpochIterator(n=4096, window=256, batch=64, seed=0,
                                 rank=0, world=1, device=device)

        def step(carry, idx_batch):
            return (carry[0] + 1, carry[1] + idx_batch.sum()), idx_batch[0]

        zero = torch.zeros((), dtype=torch.int64, device=device)
        (steps_done, total), firsts = it.run_epoch(0, step, (zero, zero),
                                                   collect=True)
        assert int(steps_done) == it.steps_per_epoch == firsts.numel()
        assert int(total) == 4096 * 4095 // 2  # every index once
        print(f"ok: run_epoch ran {int(steps_done)} steps over the epoch's "
              "batch views, no launch per step")

        # 3. host-resident rows, gathered into pinned memory and copied to
        #    the device one step ahead on a background thread
        rows = np.arange(4096 * 8).reshape(4096, 8)
        backend = "cpu" if device == "cpu" else "cuda"
        loader = HostDataLoader({"tokens": rows}, window=256, batch=64,
                                seed=0, index_backend=backend,
                                device=device)
        got = sum(int(b["tokens"].sum()) for b in loader.epoch(0))
        order = torch.cat(list(DeviceEpochIterator(
            n=4096, window=256, batch=64, seed=0, device=device).epoch(0)))
        assert got == int(rows[order.cpu().numpy()].sum())
        print(f"ok: HostDataLoader served {loader.steps_per_epoch} batches "
              f"to the {device}, the same stream as the iterator")

        # 4. a three-corpus pretrain (web/code/books at 70/20/10): the
        #    mixture kernels' ids index the concatenated source space
        cfg = GPTConfig(vocab_size=128, seq_len=16, d_model=64, n_layers=1,
                        n_heads=2, d_ff=128)
        spec = MixtureSpec([120, 80, 56], [70, 20, 10], windows=16,
                           block=16)
        corpus = synthetic_tokens(cfg, spec.total_sources_len, 1, device)
        model, opt = create_state(cfg, mesh, seed=0)
        run = make_mixture_run_runner(cfg, opt, mesh, 2, 2, 2, spec)
        losses = run(model, corpus,
                     parallel.make_seed_triple(7, 0, mesh=mesh), 0)
        assert bool(torch.isfinite(losses).all())
        print(f"ok: mixture run runner trained {losses.numel()} steps over "
              f"{spec.num_sources} corpora (losses "
              f"{[round(float(v), 2) for v in losses.reshape(-1)]})")


if __name__ == "__main__":
    main()
