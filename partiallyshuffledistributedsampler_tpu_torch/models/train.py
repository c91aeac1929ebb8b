"""Training on the card from device-resident sampler indices.

The integration the sampler exists for: each epoch's index tensor is
generated on the card by the index kernels (seed agreement over the data
mesh included, ``parallel/sharded.py``), and every train step gathers its
batch rows from it on the card, so the host never touches an index.

One process drives one GPU (``parallel/mesh.py``): the data mesh's group
is the dp axis.  A step takes this rank's window of its row of the epoch
tensor, gathers the rows, computes the loss as a mean, runs backward,
averages the gradients over the group in one all-reduce (none at world 1)
and steps the optimizer.  The loss it returns is the global mean, on the
device.  The optimizer is ``torch.optim.AdamW`` with optax's
``adamw(3e-4)`` hyperparameters.

``make_epoch_runner``, ``make_run_runner`` and ``make_mixture_run_runner``
are the JAX package's ``lax.scan`` programs as Python loops over the same
step: a whole run queues its regens and steps without waiting for the
card, which is the port's counterpart of "zero host round-trips" (a run
passes under ``torch.cuda.set_sync_debug_mode("error")``).  Epoch e+1's
regen is launched ahead of epoch e's steps, so the host never waits on
it and the card has it before e+1 begins.

The JAX package's Megatron tp placement has no counterpart: it is a
layout hint that does not change results, the sampler partitions only dp,
and a GPT-2-small or ViT-L/16 model fits one H100 whole.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from ..parallel.mesh import identity_from_mesh
from ..parallel.sharded import (
    make_mixture_regen_fn,
    make_regen_fn,
    make_seed_triple,
    sharded_epoch_indices,
)
from ..sampler.device_iterator import batch_index_window
from .gpt import GPTConfig, forward, init_params

#: optax.adamw(3e-4)'s hyperparameters (torch's default weight decay is
#: 1e-2, optax's 1e-4)
ADAMW = dict(lr=3e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def mesh_axis(mesh: DeviceMesh) -> str:
    """The data mesh's one axis: the dp axis."""
    if mesh.ndim != 1:
        raise ValueError(f"a 1-D data mesh is required, got {mesh.ndim} "
                         "dimensions")
    return mesh.mesh_dim_names[0]


def make_optimizer(model: torch.nn.Module) -> torch.optim.AdamW:
    return torch.optim.AdamW(model.parameters(), **ADAMW)


def create_state(cfg: GPTConfig, mesh: DeviceMesh, seed: int = 0):
    """``(model, opt)``: the model initialised from a host generator seeded
    with ``seed`` (every rank draws the same parameters) and placed on the
    mesh's device, and its AdamW."""
    model = init_params(cfg, torch.Generator().manual_seed(int(seed)))
    model = model.to(mesh.device_type)
    return model, make_optimizer(model)


def mean_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``-mean(log_softmax(logits)[target])`` in float32, as the JAX
    package's losses compute it (``take_along_axis`` is ``gather``)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets.long()[..., None])[..., 0].mean()


def lm_loss(cfg: GPTConfig, model, batch: torch.Tensor) -> torch.Tensor:
    """Next-token loss of token rows ``[b, seq+1]``."""
    return mean_nll(forward(cfg, model, batch[:, :-1]), batch[:, 1:])


def make_step(opt: torch.optim.Optimizer, mesh: DeviceMesh, batch_per_dp: int,
              loss_of):
    """The step shared by the GPT and ViT consumers:
    ``step(model, epoch_idx, step, *tables) -> loss``.  ``loss_of(model,
    idx, *tables)`` gathers the rows of ``idx`` from ``tables`` and returns
    the rank's mean loss."""
    world, _rank = identity_from_mesh(mesh, mesh_axis(mesh))
    group = mesh.get_group(mesh_axis(mesh))
    params = [p for g in opt.param_groups for p in g["params"]]

    def step_fn(model, epoch_idx: torch.Tensor, step, *tables):
        win = batch_index_window(epoch_idx, step, batch_per_dp)
        opt.zero_grad(set_to_none=True)
        loss = loss_of(model, win, *tables)
        loss.backward()
        loss = loss.detach()
        if world > 1:
            # the gradients and the loss in one buffer, one all-reduce
            flat = torch.cat([p.grad.reshape(-1) for p in params]
                             + [loss.reshape(1)])
            dist.all_reduce(flat, group=group)
            flat /= world
            at = 0
            for p in params:
                p.grad.copy_(flat[at:at + p.numel()].view_as(p))
                at += p.numel()
            loss = flat[-1]
        opt.step()
        return loss

    return step_fn


def make_train_step(cfg: GPTConfig, opt: torch.optim.Optimizer,
                    mesh: DeviceMesh, batch_per_dp: int):
    """``step(model, tokens, epoch_idx, step) -> loss``: ``epoch_idx`` is
    this rank's row of the agreed epoch tensor, ``tokens`` the token table
    ``[n, seq+1]`` on the mesh's device; the batch rows are gathered on the
    device.  Updates ``model`` (through ``opt``) in place; the loss is the
    global mean over the dp group, on the device."""

    def loss_of(model, win, tokens):
        return lm_loss(cfg, model, tokens.index_select(0, win))

    step_fn = make_step(opt, mesh, batch_per_dp, loss_of)

    def train_step(model, tokens, epoch_idx, step):
        return step_fn(model, epoch_idx, step, tokens)

    return train_step


def make_epoch_runner(cfg: GPTConfig, opt: torch.optim.Optimizer,
                      mesh: DeviceMesh, batch_per_dp: int,
                      steps_per_epoch: int):
    """A whole epoch of steps: ``run(model, tokens, epoch_idx) ->
    losses[steps_per_epoch]`` on the device."""
    step = make_train_step(cfg, opt, mesh, batch_per_dp)

    def epoch_fn(model, tokens, epoch_idx):
        return torch.stack([step(model, tokens, epoch_idx, s)
                            for s in range(steps_per_epoch)])

    return epoch_fn


def make_run_runner(cfg: GPTConfig, opt: torch.optim.Optimizer,
                    mesh: DeviceMesh, batch_per_dp: int, steps_per_epoch: int,
                    n_epochs: int, n_samples: int, window: int, *,
                    sampler_kwargs: Optional[dict] = None):
    """The whole multi-epoch run: ``run(model, tokens, triple,
    first_epoch) -> losses[n_epochs, steps_per_epoch]`` on the device.
    Each epoch's index tensor is regenerated on the card from ``triple``
    (``parallel.make_seed_triple(seed, 0, mesh=mesh)``, its epoch word set
    per epoch) through ``parallel.make_regen_fn``, which agrees on rank
    0's triple over the mesh; ``sampler_kwargs`` forwards the permutation
    options to it (an unknown key raises ``TypeError`` there)."""
    regen_fn, num_samples = make_regen_fn(
        n_samples, window, mesh=mesh, axis=mesh_axis(mesh),
        **(sampler_kwargs or {}))
    return _run_runner_from_regen(cfg, opt, mesh, batch_per_dp,
                                  steps_per_epoch, n_epochs, regen_fn,
                                  num_samples)


def make_mixture_run_runner(cfg: GPTConfig, opt: torch.optim.Optimizer,
                            mesh: DeviceMesh, batch_per_dp: int,
                            steps_per_epoch: int, n_epochs: int, spec, *,
                            sampler_kwargs: Optional[dict] = None):
    """The §8 counterpart of :func:`make_run_runner`: each epoch's ids come
    from the mixture kernels (``parallel.make_mixture_regen_fn``) and index
    the concatenated source space (``tokens`` holds
    ``spec.total_sources_len`` rows).  Same signature and triple."""
    regen_fn, num_samples = make_mixture_regen_fn(
        spec, mesh=mesh, axis=mesh_axis(mesh), **(sampler_kwargs or {}))
    return _run_runner_from_regen(cfg, opt, mesh, batch_per_dp,
                                  steps_per_epoch, n_epochs, regen_fn,
                                  num_samples)


def triple_at_epoch(triple: torch.Tensor, epoch) -> torch.Tensor:
    """A copy of the seed triple with its epoch word set to ``epoch``'s
    uint32 bits (int32 storage), written on the triple's device by a fill
    (an element assignment would copy from host memory and synchronise)."""
    e = int(epoch) & 0xFFFFFFFF
    t = triple.clone()
    t.narrow(0, 2, 1).fill_(e - (1 << 32) if e > 0x7FFFFFFF else e)
    return t


def _run_runner_from_regen(cfg: GPTConfig, opt, mesh: DeviceMesh,
                           batch_per_dp: int, steps_per_epoch: int,
                           n_epochs: int, regen_fn, num_samples: int):
    """The whole-run loop over any ``triple -> row`` regen function
    (single-source or mixture)."""
    whole = num_samples // batch_per_dp
    if not 0 < steps_per_epoch <= whole:
        # a window past the row would be short (a slice clamps): refuse
        raise ValueError(
            f"steps_per_epoch={steps_per_epoch} not in [1, {whole}] "
            f"({num_samples} samples/rank / batch_per_dp={batch_per_dp})")
    epoch_fn = make_epoch_runner(cfg, opt, mesh, batch_per_dp,
                                 steps_per_epoch)

    def run_fn(model, tokens, triple, first_epoch):
        first = int(first_epoch)
        losses = []
        nxt = regen_fn(triple_at_epoch(triple, first))
        for i in range(n_epochs):
            idx = nxt
            if i + 1 < n_epochs:  # queued ahead of this epoch's steps
                nxt = regen_fn(triple_at_epoch(triple, first + i + 1))
            losses.append(epoch_fn(model, tokens, idx))
        return torch.stack(losses)

    return run_fn


def synthetic_tokens(cfg: GPTConfig, n_samples: int, seed: int,
                     device) -> torch.Tensor:
    """int32 token rows ``[n_samples, seq+1]`` drawn on ``device`` from a
    generator seeded with ``seed``."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randint(0, cfg.vocab_size, (n_samples, cfg.seq_len + 1),
                         generator=g, device=device, dtype=torch.int32)


def demo_training_run(
    mesh: DeviceMesh,
    cfg: Optional[GPTConfig] = None,
    *,
    n_samples: int = 512,
    window: int = 64,
    batch_per_dp: int = 4,
    steps_per_epoch: int = 2,
    epochs: int = 2,
    seed: int = 0,
    scan_epochs: bool = False,
    one_program: bool = False,
) -> list:
    """Synthetic tokens -> per-epoch regen on the card with seed agreement
    -> train steps; returns the per-step losses as floats (read once, at
    the end).  ``scan_epochs`` drives each epoch through
    ``make_epoch_runner``; ``one_program`` the whole run through
    ``make_run_runner``; the default is the per-step loop.  All three run
    the same steps in the same order."""
    cfg = cfg or GPTConfig()
    tokens = synthetic_tokens(cfg, n_samples, seed + 1, mesh.device_type)
    model, opt = create_state(cfg, mesh, seed)
    axis = mesh_axis(mesh)
    if one_program:
        run = make_run_runner(cfg, opt, mesh, batch_per_dp, steps_per_epoch,
                              epochs, n_samples, window)
        losses = run(model, tokens, make_seed_triple(seed, 0, mesh=mesh), 0)
        return losses.reshape(-1).tolist()
    if scan_epochs:
        run = make_epoch_runner(cfg, opt, mesh, batch_per_dp,
                                steps_per_epoch)
    else:
        step = make_train_step(cfg, opt, mesh, batch_per_dp)
    losses = []
    for epoch in range(epochs):
        idx = sharded_epoch_indices(n_samples, window, seed, epoch,
                                    mesh=mesh, axis=axis)
        if scan_epochs:
            losses.append(run(model, tokens, idx))
        else:
            losses.append(torch.stack([step(model, tokens, idx, s)
                                       for s in range(steps_per_epoch)]))
    return torch.stack(losses).reshape(-1).tolist()
