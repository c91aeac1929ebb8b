"""Second consumer family: a ViT image classifier as a torch module
(BASELINE.json names ViT-L/16 as the image consumer the sampler feeds).

The same end-to-end shape as the GPT consumer: the epoch index tensor
lives on the card (``parallel.sharded_epoch_indices``), and each step
gathers its images and labels there.  Images are NHWC, as in the JAX
package; the patch embedding is flax's VALID ``nn.Conv`` with stride =
patch, here ``conv2d`` on the permuted input with the HWIO kernel carried
as OIHW.  The encoder reuses ``Block(causal=False)``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import identity_from_mesh
from ..parallel.sharded import sharded_epoch_indices
from .gpt import Block, Dense, Embed, LayerNorm, init_module_
from .train import mean_nll, make_optimizer, make_step, mesh_axis


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 32
    patch_size: int = 4
    channels: int = 3
    num_classes: int = 10
    d_model: int = 128
    n_layers: int = 2
    n_heads: int = 4
    d_ff: int = 512
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.image_size % self.patch_size:
            raise ValueError(
                f"image_size {self.image_size} not divisible by patch_size "
                f"{self.patch_size} (the VALID-padded patch conv would "
                "silently drop edge pixels)"
            )

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


class PatchConv(nn.Module):
    """flax ``nn.Conv(D, (p, p), strides=(p, p), padding="VALID")`` on
    NHWC input: ``weight`` is OIHW, and the convolution and the bias add
    run in the compute dtype."""

    def __init__(self, channels: int, d: int, p: int) -> None:
        super().__init__()
        self.p = p
        self.weight = nn.Parameter(torch.empty(d, channels, p, p))
        self.bias = nn.Parameter(torch.zeros(d))
        self.fan_in = channels * p * p  # lecun-normal initialisation

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), self.weight.to(dtype),
                     stride=self.p)
        return y.permute(0, 2, 3, 1) + self.bias.to(dtype)  # NHWC


class MiniViT(nn.Module):
    """Patch embedding, a zero-initialised ``cls`` token, learned positions
    (``wpe``), ``n_layers`` bidirectional blocks, a final LayerNorm and an
    f32 head on the cls token.  Parameter names follow the flax module's."""

    def __init__(self, cfg: ViTConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.patch = PatchConv(cfg.channels, cfg.d_model, cfg.patch_size)
        self.cls = nn.Parameter(torch.zeros(1, 1, cfg.d_model))
        self.wpe = Embed(cfg.num_patches + 1, cfg.d_model)
        for i in range(cfg.n_layers):
            self.add_module(f"block{i}", Block(cfg, causal=False))
        self.lnf = LayerNorm(cfg.d_model)
        self.head = Dense(cfg.d_model, cfg.num_classes)

    def forward(self, images: torch.Tensor) -> torch.Tensor:  # [B, H, W, C]
        dt = self.cfg.dtype
        x = self.patch(images.to(dt), dt)
        B, h, w, D = x.shape
        x = x.reshape(B, h * w, D)
        x = torch.cat([self.cls.expand(B, 1, D).to(dt), x], dim=1)
        x = x + self.wpe.weight.to(dt)[None]
        for i in range(self.cfg.n_layers):
            x = getattr(self, f"block{i}")(x)
        return self.head(self.lnf(x, dt)[:, 0], torch.float32)


def init_vit_params(cfg: ViTConfig, generator: torch.Generator) -> MiniViT:
    """A ``MiniViT`` with float32 parameters on the host, initialised from
    ``generator`` with flax's initializer families."""
    model = MiniViT(cfg)
    init_module_(model, generator)
    return model


def vit_forward(cfg: ViTConfig, model: MiniViT,
                images: torch.Tensor) -> torch.Tensor:
    """float32 logits ``[B, num_classes]`` of NHWC ``images``."""
    if model.cfg != cfg:
        raise ValueError(f"model was built for {model.cfg}, not {cfg}")
    return model(images)


def make_vit_train_step(cfg: ViTConfig, opt, mesh, batch_per_dp: int):
    """``step(model, images, labels, epoch_idx, step) -> loss``: the
    images and labels of this rank's window are gathered on the device,
    then the step of ``models/train.py`` (loss as a mean, one all-reduce
    of the gradients over the dp group, AdamW)."""
    def loss_of(model, win, images, labels):
        return mean_nll(vit_forward(cfg, model, images.index_select(0, win)),
                         labels.index_select(0, win))

    step_fn = make_step(opt, mesh, batch_per_dp, loss_of)

    def train_step(model, images, labels, epoch_idx, step):
        return step_fn(model, epoch_idx, step, images, labels)

    return train_step


def synthetic_images(cfg: ViTConfig, n_samples: int, seed: int, device):
    """``(images, labels)``: float32 NHWC images and int32 labels drawn on
    ``device`` from a generator seeded with ``seed``."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    images = torch.randn(n_samples, cfg.image_size, cfg.image_size,
                         cfg.channels, generator=g, device=device)
    labels = torch.randint(0, cfg.num_classes, (n_samples,), generator=g,
                           device=device, dtype=torch.int32)
    return images, labels


def demo_vit_run(mesh, cfg: ViTConfig, *, n_samples=256, window=32,
                 batch_per_dp=4, steps_per_epoch=2, epochs=2, seed=0):
    """Synthetic images -> per-epoch regen on the card with seed agreement
    -> ViT train steps.  Returns the per-step losses as floats (read once,
    at the end)."""
    world, _rank = identity_from_mesh(mesh, mesh_axis(mesh))
    per_rank = -(-n_samples // world)
    if steps_per_epoch * batch_per_dp > per_rank:
        # a window past the row would be short (a slice clamps): refuse
        raise ValueError(
            f"steps_per_epoch={steps_per_epoch} x batch_per_dp="
            f"{batch_per_dp} exceeds the {per_rank} samples/rank")
    model = init_vit_params(cfg, torch.Generator().manual_seed(int(seed)))
    model = model.to(mesh.device_type)
    opt = make_optimizer(model)
    images, labels = synthetic_images(cfg, n_samples, seed, mesh.device_type)
    step = make_vit_train_step(cfg, opt, mesh, batch_per_dp)
    losses = []
    for e in range(epochs):
        idx = sharded_epoch_indices(n_samples, window, seed, e, mesh=mesh,
                                    axis=mesh_axis(mesh))
        for s in range(steps_per_epoch):
            losses.append(step(model, images, labels, idx, s))
    return torch.stack(losses).tolist()
