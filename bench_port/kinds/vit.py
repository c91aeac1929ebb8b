"""ViT (``model.kind`` "vit"): image rows and the port's ``MiniViT`` with
``make_vit_train_step``, ViT's plain reference, its leaves and FLOPs
(``kinds/__init__.py`` gives the contract).

An image row holds its id in its first four bytes (little-endian) and
(PIX_STRIDE * id + j) % PIX_MOD at byte j; its label is (id *
LABEL_STRIDE) % classes.  Rows are served as uint8 and widened to float32
in [-1, 1] on the card."""

from __future__ import annotations

import numpy as np
import torch

from bench_port import kinds, weights
from bench_port.counts import model as model_counts
from bench_port.reference import models as ref

PIX_STRIDE, PIX_MOD, LABEL_STRIDE = 7, 251, 7919


def _image_shape(m: dict) -> tuple:
    return (m["image_size"], m["image_size"], m["channels"])


def host_rows(config: dict, alloc=np.empty):
    m = config["model"]
    rows = config["host_shards"] * config["shard_size"]
    shape = _image_shape(m)
    size = int(np.prod(shape))
    tmpl = (np.arange(size + PIX_MOD, dtype=np.int64) % PIX_MOD).astype(
        np.uint8)
    out = alloc((rows, size), np.uint8)
    kinds.fill(out, tmpl, lambda r: (PIX_STRIDE * r) % PIX_MOD)
    out[:, :4] = np.arange(rows, dtype="<u4").view(np.uint8).reshape(rows, 4)
    labels = alloc((rows,), np.int32)
    labels[:] = ((np.arange(rows, dtype=np.int64) * LABEL_STRIDE)
                 % m["num_classes"]).astype(np.int32)
    return {"x": out.reshape((rows,) + shape), "y": labels}


def widen_pixels(x: torch.Tensor) -> torch.Tensor:
    return x.float().mul_(2.0 / 255.0).sub_(1.0)


def widen(b: dict) -> dict:
    """The row check reads the served uint8 pixels; ``step_inputs`` widens
    the rows it feeds."""
    return b


def alter(b: dict) -> None:
    b["x"][0, 0, 1, 2] += 1


def row_check(config: dict, device):
    m = config["model"]
    byte_pos = torch.arange(int(np.prod(_image_shape(m))), dtype=torch.int32,
                            device=device)

    def check(b, want):
        x, y = b["x"], b["y"]
        flat = x.reshape(x.shape[0], -1)
        w = flat[:, :4].to(torch.int64)
        rid = w[:, 0] + (w[:, 1] << 8) + (w[:, 2] << 16) + (w[:, 3] << 24)
        pix = (PIX_STRIDE * rid.to(torch.int32))[:, None] + byte_pos
        return ((rid != want).sum() + (y.long() != (
            rid * LABEL_STRIDE) % m["num_classes"]).sum()
            + (flat[:, 4:] != (pix[:, 4:] % PIX_MOD)).sum())

    return check


def step_inputs(b: dict, fed: int) -> tuple:
    return widen_pixels(b["x"][:fed]), b["y"][:fed]


def program(m: dict, device):
    from partiallyshuffledistributedsampler_tpu_torch.models import vit

    widths = {k: m[k] for k in m if k not in ("kind", "dtype")}
    with torch.device(device):
        cfg = vit.ViTConfig(dtype=getattr(torch, m["dtype"]), **widths)
        model = vit.MiniViT(cfg)

    def make_step(opt, mesh, batch):
        return vit.make_vit_train_step(cfg, opt, mesh, batch)

    return model, make_step


def reference_batch(data: dict, ids: np.ndarray, device) -> dict:
    x = torch.from_numpy(data["x"][ids]).to(device)
    y = torch.from_numpy(data["y"][ids]).to(device)
    return {"images": widen_pixels(x), "labels": y}


def leaves(m: dict) -> list:
    d, p, c = m["d_model"], m["patch_size"], m["channels"]
    patches = (m["image_size"] // p) ** 2
    return weights.transformer_leaves(
        m, [("patch.weight", (d, c, p, p), c * p * p),
            ("patch.bias", (d,), "zero"),
            ("cls", (1, 1, d), "zero"),
            ("wpe.weight", (patches + 1, d), d)], m["num_classes"])


def reference_loss(w: dict, m: dict, batch: dict, fp8=False):
    """Mean class negative log-likelihood of ``batch["images"]`` (float32
    NHWC) against ``batch["labels"]``."""
    return ref.nll(ref.vit_logits(w, m, batch["images"], fp8),
                   batch["labels"].long())


def train_step_flops(m: dict, batch: int) -> float:
    d = m["d_model"]
    patches = (m["image_size"] // m["patch_size"]) ** 2
    t = patches + 1
    patch = m["channels"] * m["patch_size"] ** 2 * d
    matmul = 6 * batch * (model_counts.block_params(m) * t + patch * patches
                          + d * m["num_classes"])
    return float(matmul + model_counts.attention_flops(m, batch, t))
