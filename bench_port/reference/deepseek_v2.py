"""Plain float32 DeepSeek-V2 forward and loss, in torch: one GPU's
expert-parallel share, as the configuration states it.

Written from the DeepSeek-V2 paper (arXiv:2405.04434) and the published
DeepSeek-V2-Lite configuration, independent of the program: it imports
nothing of it.  Per layer, with ``h`` the RMSNorm'd input:

- attention: ``q = W_q h`` split per head into a 128-wide part and a 64-wide
  rope part; ``[c; k_pe] = W_kva h``, ``c`` RMSNorm'd, ``[k_nope; v] = W_kvb
  c`` per head; the rope parts rotated pairwise (dimensions 2i and 2i+1 by
  position x frequency i, YaRN's frequencies), one ``k_pe`` for all heads;
  softmax over the causal scores at ``mscale^2 / sqrt(192)``;
- the first layer a dense SwiGLU, the others: the router's softmax over
  every routed expert, its top k with their weights as they are, the held
  experts' SwiGLUs on the tokens that chose them, weighted and added, plus
  the shared experts' SwiGLU;
- the sequence-wise balance loss over every routed expert, summed over the
  layers and added to the mean next-token negative log-likelihood.

Departures: no kernels and no fusion; plain softmax attention (the causal
mask as -inf, every score computed); each layer under
``torch.utils.checkpoint`` so that one 4,096-token sequence fits beside
the training state (the recomputation repeats the same float32 arithmetic;
a token's routing depends only on the layer's input, so it does not move);
the expert outputs added in float32 like everything else.  With
``fp8=True`` every projection's input and weight are rounded to float8
e4m3 (``models._fp8``): the lower precision of the correctness control.
A batch may carry ``routes``, a dict that the forward fills with each MoE
layer's top-k expert ids (the first forward's, not the recomputation's).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench_port.reference.models import _fp8, nll


def _proj(x, w, fp8: bool):
    if fp8:  # an expert that no token chose has no input to round
        x, w = (_fp8(x) if x.numel() else x), _fp8(w)
    return x @ w.t()


def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _swiglu(x, gate_up, down, fp8):
    f = down.shape[-1]
    a = _proj(x, gate_up, fp8)
    return _proj(F.silu(a[..., :f]) * a[..., f:], down, fp8)


def yarn(m: dict) -> tuple:
    """``(inv_freq, mscale)``: the rope frequencies and the attention's
    temperature from the configuration's ``rope_scaling`` (YaRN, arXiv
    2309.00071): dimension pair i keeps ``theta^(-2i/d)`` where a
    wavelength completes more than ``beta_fast`` turns in the original
    context, takes it divided by the factor where fewer than ``beta_slow``,
    and a linear blend between."""
    rs, d, base = m["rope_scaling"], m["qk_rope_head_dim"], m["rope_theta"]
    i = torch.arange(d // 2, dtype=torch.float64)
    theta = base ** (-2 * i / d)

    def pair_at(turns):  # the pair whose wavelength makes ``turns`` turns
        return d * math.log(rs["original_max_position_embeddings"]
                            / (turns * 2 * math.pi)) / (2 * math.log(base))

    lo = max(math.floor(pair_at(rs["beta_fast"])), 0)
    hi = min(math.ceil(pair_at(rs["beta_slow"])), d - 1)
    blend = ((i - lo) / max(hi - lo, 1e-3)).clamp(0, 1)  # 1: interpolate
    inv = theta * (1 - blend) + theta / rs["factor"] * blend
    return inv.float(), _mscale(rs, "mscale_all_dim")


def _mscale(rs: dict, key: str) -> float:
    return 0.1 * rs[key] * math.log(rs["factor"]) + 1.0


def _rotate(x, cos, sin):
    """Pairs (2i, 2i+1) of the last dimension rotated by angle i."""
    even, odd = x[..., 0::2], x[..., 1::2]
    return torch.stack((even * cos - odd * sin, even * sin + odd * cos),
                       dim=-1).flatten(-2)


def _attention(w, p, m, x, cos, sin, fp8):
    b, t, _ = x.shape
    heads, nope = m["num_attention_heads"], m["qk_nope_head_dim"]
    rope, vd = m["qk_rope_head_dim"], m["v_head_dim"]
    q = _proj(x, w[p + "self_attn.q_proj.weight"], fp8).view(
        b, t, heads, nope + rope)
    ckv = _proj(x, w[p + "self_attn.kv_a_proj_with_mqa.weight"], fp8)
    c = _rms(ckv[..., :m["kv_lora_rank"]],
             w[p + "self_attn.kv_a_layernorm.weight"], m["rms_norm_eps"])
    k_pe = _rotate(ckv[..., m["kv_lora_rank"]:], cos, sin)  # [b, t, rope]
    kv = _proj(c, w[p + "self_attn.kv_b_proj.weight"], fp8).view(
        b, t, heads, nope + vd)
    q = torch.cat([q[..., :nope], _rotate(q[..., nope:], cos[:, None],
                                          sin[:, None])], dim=-1)
    k = torch.cat([kv[..., :nope], k_pe[:, :, None].expand(
        b, t, heads, rope)], dim=-1)
    q, k, v = (z.transpose(1, 2) for z in (q, k, kv[..., nope:]))
    _, mscale = yarn(m)
    scores = (q @ k.transpose(-1, -2)) * (mscale ** 2 / math.sqrt(nope
                                                                   + rope))
    mask = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    att = scores.masked_fill(~mask, float("-inf")).softmax(-1)
    out = (att @ v).transpose(1, 2).reshape(b, t, heads * vd)
    return _proj(out, w[p + "self_attn.o_proj.weight"], fp8)


def _moe(w, p, m, h, fp8, routes, layer):
    """The held experts' part and the shared experts; ``(y, aux)``."""
    b, t, d = h.shape
    x = h.reshape(b * t, d)
    E, k = m["n_routed_experts"], m["num_experts_per_tok"]
    scores = (x @ w[p + "mlp.gate.weight"].t()).softmax(-1)  # float32
    weight, chosen = scores.topk(k, dim=-1)
    if routes is not None:
        routes.setdefault(layer, chosen.detach())
    y = torch.zeros_like(x)
    gate_up, down = w[p + "mlp.experts_gate_up.weight"], \
        w[p + "mlp.experts_down.weight"]
    for j in range(m["experts_held"]):  # an expert with no token adds 0
        tok, slot = (chosen == m["first_held_expert"] + j).nonzero(
            as_tuple=True)
        out = _swiglu(x[tok], gate_up[j], down[j], fp8)
        y = y + torch.zeros_like(x).index_copy(
            0, tok, out * weight[tok, slot][:, None])
    y = y + _swiglu(x, w[p + "mlp.shared.gate_up.weight"],
                    w[p + "mlp.shared.down.weight"], fp8)
    # f_e: the share of each sequence's choices naming e, times E / k
    f = F.one_hot(chosen.view(b, t * k), E).float().mean(1) * E
    aux = (f * scores.view(b, t, E).mean(1)).sum(1).mean()
    return y.view(b, t, d), m["aux_loss_alpha"] * aux


def _layer(w, i, m, x, cos, sin, fp8, routes):
    p, eps = f"layer{i}.", m["rms_norm_eps"]
    x = x + _attention(w, p, m, _rms(x, w[p + "input_layernorm.weight"], eps),
                       cos, sin, fp8)
    h = _rms(x, w[p + "post_attention_layernorm.weight"], eps)
    if i < m["first_k_dense_replace"]:
        return x + _swiglu(h, w[p + "mlp.gate_up.weight"],
                           w[p + "mlp.down.weight"], fp8), x.new_zeros(())
    y, aux = _moe(w, p, m, h, fp8, routes, i)
    return x + y, aux


def logits_and_aux(w: dict, m: dict, tokens: torch.Tensor, fp8=False,
                   routes=None) -> tuple:
    """Logits ``[B, T, vocab]`` of int64 ``tokens`` ``[B, T]`` and the
    summed balance loss."""
    t = tokens.shape[1]
    inv, _ = yarn(m)
    ang = torch.arange(t, dtype=torch.float32, device=tokens.device)[:, None] \
        * inv.to(tokens.device)
    rs = m["rope_scaling"]  # the rotation's scale: 1 where both are equal
    scale = _mscale(rs, "mscale") / _mscale(rs, "mscale_all_dim")
    cos, sin = ang.cos() * scale, ang.sin() * scale
    x = w["embed_tokens.weight"][tokens]
    aux = x.new_zeros(())
    for i in range(m["num_hidden_layers"]):
        x, a = checkpoint(_layer, w, i, m, x, cos, sin, fp8, routes,
                          use_reentrant=False)
        aux = aux + a
    x = _rms(x, w["norm.weight"], m["rms_norm_eps"])
    return _proj(x, w["lm_head.weight"], fp8), aux


def loss(w: dict, m: dict, batch: dict, fp8=False) -> torch.Tensor:
    """The mean next-token negative log-likelihood of ``batch["tokens"]``
    ``[B, T+1]`` plus the balance loss."""
    tok = batch["tokens"]
    logits, aux = logits_and_aux(w, m, tok[:, :-1], fp8, batch.get("routes"))
    return nll(logits, tok[:, 1:]) + aux
