"""Plain float32 GPT-2 and ViT forwards, their loss, and AdamW, in torch.

Written from the published descriptions (GPT-2: pre-LN decoder, learned
positions, GELU in its tanh form, causal softmax attention; ViT: a 16 x 16
patch projection, a class token, learned positions, a bidirectional
encoder, the head on the class token) and independent of the program: it
imports nothing of it.  Departures, where the configuration fixes them:
LayerNorm's epsilon is 1e-6 and the LM head is untied, with a bias.

``run_steps`` follows the program's first training steps on the same
weights and rows, with TF32 off, or one step from the program's own
parameters and AdamW moments; a step of a data-parallel job takes its
ranks' batches in turn and their mean.  With ``fp8=True`` every linear
layer's input and weight are rounded to float8 e4m3 (per-tensor scale from
the absolute maximum) on the forward pass, the gradient passing straight
through: the lower precision that serves as the correctness control.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LN_EPS = 1e-6
FP8_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = FP8_MAX / x.detach().abs().amax().clamp(min=1e-12)
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
    return x + (q - x).detach()


def _linear(x, w, b, fp8: bool):
    if fp8:
        x, w = _fp8(x), _fp8(w)
    return x @ w.t() + b


def _ln(x, w, b):
    return F.layer_norm(x, (x.shape[-1],), w, b, LN_EPS)


def _block(w, p: str, x, heads: int, causal: bool, fp8: bool):
    b_, t, d = x.shape
    hd = d // heads
    qkv = _linear(_ln(x, w[p + "ln1.weight"], w[p + "ln1.bias"]),
                  w[p + "qkv.weight"], w[p + "qkv.bias"], fp8)
    q, k, v = (z.reshape(b_, t, heads, hd).transpose(1, 2)
               for z in qkv.split(d, dim=-1))
    att = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
    if causal:
        mask = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        att = att.masked_fill(~mask, float("-inf"))
    out = (att.softmax(-1) @ v).transpose(1, 2).reshape(b_, t, d)
    x = x + _linear(out, w[p + "proj.weight"], w[p + "proj.bias"], fp8)
    h = _ln(x, w[p + "ln2.weight"], w[p + "ln2.bias"])
    h = F.gelu(_linear(h, w[p + "fc1.weight"], w[p + "fc1.bias"], fp8),
               approximate="tanh")
    return x + _linear(h, w[p + "fc2.weight"], w[p + "fc2.bias"], fp8)


def gpt_logits(w: dict, model: dict, tokens: torch.Tensor, fp8=False):
    """Logits ``[B, T, vocab]`` of int64 ``tokens`` ``[B, T]``."""
    x = w["wte.weight"][tokens] + w["wpe.weight"][:tokens.shape[1]]
    for i in range(model["n_layers"]):
        x = _block(w, f"block{i}.", x, model["n_heads"], True, fp8)
    return _linear(_ln(x, w["lnf.weight"], w["lnf.bias"]), w["head.weight"],
                   w["head.bias"], fp8)


def vit_logits(w: dict, model: dict, images: torch.Tensor, fp8=False):
    """Logits ``[B, classes]`` of float32 NHWC ``images``."""
    b_, h, wd, c = images.shape
    p = model["patch_size"]
    # [B, h/p, w/p, C, p, p]: each patch flattened as the weight's (C, p, p)
    patches = images.reshape(b_, h // p, p, wd // p, p, c).permute(
        0, 1, 3, 5, 2, 4).reshape(b_, (h // p) * (wd // p), c * p * p)
    x = _linear(patches, w["patch.weight"].reshape(model["d_model"], -1),
                w["patch.bias"], fp8)
    x = torch.cat([w["cls"].expand(b_, 1, -1), x], dim=1) + w["wpe.weight"]
    for i in range(model["n_layers"]):
        x = _block(w, f"block{i}.", x, model["n_heads"], False, fp8)
    x = _ln(x, w["lnf.weight"], w["lnf.bias"])[:, 0]
    return _linear(x, w["head.weight"], w["head.bias"], fp8)


def nll(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of ``target`` under ``logits``."""
    logp = logits.log_softmax(-1)
    return -logp.gather(-1, target[..., None])[..., 0].mean()


def loss(w: dict, model: dict, batch: dict, fp8=False) -> torch.Tensor:
    """The model kind's mean loss of ``batch`` (``kinds/<kind>.py``
    ``reference_loss``: GPT's next-token loss of ``batch["tokens"]`` ``[B,
    T+1]``, ViT's class loss of ``batch["images"]`` and
    ``batch["labels"]``)."""
    from bench_port import kinds

    return kinds.load(model["kind"]).reference_loss(w, model, batch, fp8)


def run_steps(w0: dict, model: dict, opt: dict, batches, fp8=False,
              moments=None) -> dict:
    """AdamW steps from the weights ``w0`` over ``batches`` (a dict a
    step, or a list of the ranks' dicts): each step's loss, each leaf's
    first-gradient norm and its change's norm after the last step.
    ``moments`` (``{leaf: (exp_avg, exp_avg_sq, steps taken)}``) continues
    from a state part-way through training; a leaf it lacks starts from
    nought.  TF32 stays off throughout."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _run(w0, model, opt, batches, fp8, moments or {})
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def _run(w0, model, opt, batches, fp8, moments):
    w = {k: v.detach().float().clone().requires_grad_(True)
         for k, v in w0.items()}
    m, v2, taken = {}, {}, {}
    for k, v in w.items():
        m0, v0, t0 = moments.get(k, (None, None, 0))
        m[k] = torch.zeros_like(v) if m0 is None else m0.float().clone()
        v2[k] = torch.zeros_like(v) if v0 is None else v0.float().clone()
        taken[k] = t0
    lr, (b1, b2) = opt["lr"], opt["betas"]
    eps, wd = opt["eps"], opt["weight_decay"]
    losses, grad_norms = [], None
    for i, batch in enumerate(batches, start=1):
        lv, grads = _loss_and_grads(w, model, batch, fp8)
        losses.append(float(lv))
        if grad_norms is None:
            grad_norms = leaf_norms(dict(zip(w, grads)))
        with torch.no_grad():
            for (k, p), g in zip(w.items(), grads):
                t = taken[k] + i
                bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
                p.mul_(1 - lr * wd)
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v2[k].sqrt() / math.sqrt(bc2)).add_(eps)
                p.addcdiv_(m[k], denom, value=-lr / bc1)
        del grads
    with torch.no_grad():
        change = leaf_norms({k: w[k] - w0[k] for k in w})
    return dict(losses=losses, grad_norms=grad_norms, change_norms=change)


def _loss_and_grads(w: dict, model: dict, batch, fp8: bool):
    """The loss of one step and its gradient by leaf.  ``batch`` is a dict,
    or a list of equal parts (the batches of a data-parallel job's ranks,
    in rank order), taken one at a time to fit: their mean loss and mean
    gradient, the mathematics of the ranks' all-reduced mean."""
    if isinstance(batch, dict):
        lv = loss(w, model, batch, fp8)
        return lv.detach(), torch.autograd.grad(lv, list(w.values()))
    total, acc = 0.0, None
    for part in batch:
        lv = loss(w, model, part, fp8)
        g = torch.autograd.grad(lv, list(w.values()))
        total = total + lv.detach()
        acc = list(g) if acc is None else [a.add_(b) for a, b in zip(acc, g)]
        del g
    return total / len(batch), [a.div_(len(batch)) for a in acc]


def leaf_norms(tensors: dict) -> dict:
    """The norm of each leaf, a fused query-key-value projection counted
    as three leaves (``.q``, ``.k``, ``.v``): the key's bias has no
    gradient under softmax while the query's and value's have."""
    out = {}
    for name, t in tensors.items():
        if name.endswith(("qkv.weight", "qkv.bias")):
            for part, z in zip("qkv", t.detach().chunk(3, dim=0)):
                out[f"{name}.{part}"] = float(z.float().norm())
        else:
            out[name] = float(t.detach().float().norm())
    return out


def leaf_gap(got: dict, want: dict, leaves=None) -> tuple:
    """``(gap, leaf)``: the worst leaf's gap between two norms, against the
    larger of the reference's norm of that leaf and of the median leaf."""
    keys = list(want) if leaves is None else list(leaves)
    med = float(torch.tensor([want[k] for k in want]).median())
    worst, at = 0.0, None
    for k in keys:
        gap = abs(got[k] - want[k]) / max(want[k], med, 1e-30)
        if gap >= worst:
            worst, at = gap, k
    return worst, at


def moving_leaves(grad_norms: dict, share: float = 1e-3) -> list:
    """Leaves whose reference gradient is not nought to rounding: at least
    ``share`` of the median leaf's (a key's bias, under softmax, has none
    and moves under Adam by round-off alone)."""
    med = float(torch.tensor(list(grad_norms.values())).median())
    return [k for k, g in grad_norms.items() if g >= share * med]
