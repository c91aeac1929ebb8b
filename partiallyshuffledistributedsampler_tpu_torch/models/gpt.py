"""Flagship consumer model: a GPT-2-style decoder as a torch module.

The sampler feeds consumers, and BASELINE.json names them: GPT-2-small on
C4, ViT-L/16 on images.  This decoder is the port's end-to-end vehicle:
the training step of ``models/train.py`` gathers its batch on the card
from the epoch index tensor the kernels generated, so no index reaches
the host.

The computation mirrors the JAX package's flax module op for op, with
explicit casts rather than autocast: parameters stay float32 and each
layer computes in ``cfg.dtype`` (bfloat16 by default) as flax's
``dtype=`` does.  Flax's conventions are kept where torch's differ:
LayerNorm takes its statistics in float32 with epsilon 1e-6 and casts its
result; GELU is the tanh approximation; a Dense casts its input, kernel
and bias to ``cfg.dtype`` and adds the bias after the product; an Embed
casts its table before the lookup; attention divides by ``sqrt(hd)``
rounded to ``cfg.dtype``, masks with that dtype's minimum and takes the
softmax in float32.  The LM head is a separate, untied float32 Dense.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

#: flax's LayerNorm epsilon (torch's default is 1e-5)
LN_EPS = 1e-6
#: flax's truncated normal keeps draws within 2 standard deviations; its
#: stddev is divided by this constant so the truncated draw has the
#: intended variance (flax ``variance_scaling``)
_TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 512
    seq_len: int = 64
    d_model: int = 128
    n_layers: int = 2
    n_heads: int = 4
    d_ff: int = 512
    dtype: torch.dtype = torch.bfloat16  # activations; params stay f32


class Dense(nn.Module):
    """flax ``nn.Dense``: ``weight`` is [out, in] (torch's layout), and the
    product and the bias add run in the compute dtype."""

    def __init__(self, d_in: int, d_out: int) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.zeros(d_out))
        self.fan_in = d_in  # lecun-normal initialisation

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return (F.linear(x.to(dtype), self.weight.to(dtype))
                + self.bias.to(dtype))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: statistics and affine in float32, epsilon
    1e-6, the result cast to the compute dtype."""

    def __init__(self, d: int) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape, self.weight,
                            self.bias, LN_EPS).to(dtype)


class Embed(nn.Module):
    """flax ``nn.Embed``: the table cast to the compute dtype, then rows
    taken by ``index_select`` (whose gradient is an ``index_add_``)."""

    def __init__(self, num: int, d: int) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num, d))

    def forward(self, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        rows = self.weight.to(dtype).index_select(0, ids.reshape(-1))
        return rows.view(*ids.shape, self.weight.shape[1])


class Block(nn.Module):
    """Pre-LN transformer block.  ``cfg`` duck-types d_model, n_heads,
    d_ff and dtype (a ``GPTConfig`` or a ``ViTConfig``); ``causal=False``
    is the ViT encoder's bidirectional attention."""

    def __init__(self, cfg, causal: bool = True) -> None:
        super().__init__()
        self.cfg, self.causal = cfg, causal
        d = cfg.d_model
        self.ln1 = LayerNorm(d)
        self.qkv = Dense(d, 3 * d)
        self.proj = Dense(d, d)
        self.ln2 = LayerNorm(d)
        self.fc1 = Dense(d, cfg.d_ff)
        self.fc2 = Dense(cfg.d_ff, d)
        hd = d // cfg.n_heads
        # jnp.sqrt(hd).astype(dtype): the divisor rounded to the dtype
        self._scale = float(torch.tensor(math.sqrt(hd)).to(cfg.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c, dt = self.cfg, self.cfg.dtype
        B, T, D = x.shape
        hd = D // c.n_heads
        q, k, v = self.qkv(self.ln1(x, dt), dt).split(D, dim=-1)
        q, k, v = (t.reshape(B, T, c.n_heads, hd).transpose(1, 2)
                   for t in (q, k, v))
        att = torch.matmul(q, k.transpose(-1, -2)) / self._scale
        if self.causal:
            mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
            att = torch.where(mask, att, torch.finfo(dt).min)
        att = torch.softmax(att.float(), dim=-1).to(dt)
        out = torch.matmul(att, v).transpose(1, 2).reshape(B, T, D)
        x = x + self.proj(out, dt)
        ff = F.gelu(self.fc1(self.ln2(x, dt), dt), approximate="tanh")
        return x + self.fc2(ff, dt)


class MiniGPT(nn.Module):
    """Decoder-only LM: token and position embeddings, ``n_layers`` causal
    blocks (``block0`` ...), a final LayerNorm and an untied f32 head.
    Parameter names follow the flax module's (``models/convert.py``)."""

    def __init__(self, cfg: GPTConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.wte = Embed(cfg.vocab_size, cfg.d_model)
        self.wpe = Embed(cfg.seq_len, cfg.d_model)
        for i in range(cfg.n_layers):
            self.add_module(f"block{i}", Block(cfg))
        self.lnf = LayerNorm(cfg.d_model)
        self.head = Dense(cfg.d_model, cfg.vocab_size)

    def blocks(self):
        return [getattr(self, f"block{i}") for i in range(self.cfg.n_layers)]

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        x = self.wte(tokens, dt)
        x = x + self.wpe.weight[:tokens.shape[1]].to(dt)[None]
        for blk in self.blocks():
            x = blk(x)
        return self.head(self.lnf(x, dt), torch.float32)


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> None:
    """flax's ``lecun_normal``: a truncated normal of variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                              generator=generator)


def init_module_(model: nn.Module, generator: torch.Generator) -> None:
    """Flax's initializer families, drawn in parameter order from
    ``generator``: lecun-normal Dense and Conv kernels, an Embed table of
    variance 1/d, and the zeros and ones the modules were built with."""
    for mod in model.modules():
        if hasattr(mod, "fan_in"):  # Dense, and the ViT's patch Conv
            lecun_normal_(mod.weight, mod.fan_in, generator)
        elif isinstance(mod, Embed):
            with torch.no_grad():
                nn.init.normal_(mod.weight, 0.0,
                                math.sqrt(1.0 / mod.weight.shape[1]),
                                generator=generator)


def init_params(cfg: GPTConfig, generator: torch.Generator) -> MiniGPT:
    """A ``MiniGPT`` with float32 parameters on the host, initialised from
    ``generator``."""
    model = MiniGPT(cfg)
    init_module_(model, generator)
    return model


def forward(cfg: GPTConfig, model: MiniGPT, tokens: torch.Tensor):
    """float32 logits ``[B, T, vocab]`` of ``tokens`` ``[B, T]``."""
    if model.cfg != cfg:
        raise ValueError(f"model was built for {model.cfg}, not {cfg}")
    return model(tokens)
