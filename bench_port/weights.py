"""Model weights made from the run's seed, on the device, in float32 (the
type the port trains them in): one normal draw for every random leaf, then
a scale per leaf.  The same weights go to the program and to the plain
reference, under the leaf names that both read."""

from __future__ import annotations

import math

import torch

from bench_port import kinds


def _block_leaves(prefix: str, d: int, f: int) -> list:
    leaves = []
    for ln in ("ln1", "ln2"):
        leaves += [(f"{prefix}{ln}.weight", (d,), "one"),
                   (f"{prefix}{ln}.bias", (d,), "zero")]
    for name, d_in, d_out in (("qkv", d, 3 * d), ("proj", d, d),
                              ("fc1", d, f), ("fc2", f, d)):
        leaves += [(f"{prefix}{name}.weight", (d_out, d_in), d_in),
                   (f"{prefix}{name}.bias", (d_out,), "zero")]
    return leaves


def transformer_leaves(model: dict, embed: list, classes: int) -> list:
    """A pre-LN transformer's leaves: ``embed`` (the kind's own input
    leaves), the blocks, the final norm and a head of ``classes``."""
    d, f = model["d_model"], model["d_ff"]
    out = list(embed)
    for i in range(model["n_layers"]):
        out += _block_leaves(f"block{i}.", d, f)
    out += [("lnf.weight", (d,), "one"), ("lnf.bias", (d,), "zero"),
            ("head.weight", (classes, d), d), ("head.bias", (classes,),
                                               "zero")]
    return out


def leaves(model: dict) -> list:
    """``(name, shape, init)`` of every leaf, by the model's kind
    (``kinds/<kind>.py``): ``init`` is a fan-in (a normal of variance
    1/fan_in), "one" or "zero"."""
    return kinds.load(model["kind"]).leaves(model)


def make(model: dict, seed: int, device) -> dict:
    """The leaves drawn from ``seed``: ``{name: float32 tensor}``."""
    specs = leaves(model)
    total = sum(math.prod(s) for _, s, init in specs
                if not isinstance(init, str))
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, init in specs:
        if init == "one":
            out[name] = torch.ones(shape, device=device)
        elif init == "zero":
            out[name] = torch.zeros(shape, device=device)
        else:
            size = math.prod(shape)
            out[name] = flat[at:at + size].view(shape).mul(
                math.sqrt(1.0 / init))
            at += size
    return out


def train_state(model: dict, seed: int, device) -> list:
    """A rank's training state as it lies on the card between two steps:
    the weights from ``seed`` and three float32 buffers of their size (the
    gradients and AdamW's two moments), made in two calls."""
    w = make(model, seed, device)
    n = sum(v.numel() for v in w.values())
    return [w, torch.zeros(3 * n, device=device)]
