"""DeepSeek-V2 (``model.kind`` "deepseek_v2"): token rows, the port's
``DeepSeekV2`` with ``make_deepseek_train_step``, the plain reference, its
leaves and FLOPs (``kinds/__init__.py`` gives the contract).

The configuration keeps the published ``config.json`` keys at its top
level; ``model_of`` joins them to its ``model`` group (the kind, the
compute dtype, the sequence length, the first held expert and the balance
loss's alpha) into the model dict that the drivers, the weights and the
reference read.  Token rows are GPT's (``kinds/gpt.py``: served as uint16
and widened on the card), with the row's id held in its first two tokens
in base ``vocab_size`` (id % vocab, id // vocab), so that every token lies
in the held slice of the vocabulary.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_port import kinds
from bench_port.harness import BenchError
from bench_port.reference import deepseek_v2 as ref

gpt = kinds.load("gpt")

#: the published keys the model reads
WIDTHS = ("vocab_size", "hidden_size", "num_hidden_layers",
          "num_attention_heads", "kv_lora_rank", "qk_nope_head_dim",
          "qk_rope_head_dim", "v_head_dim", "intermediate_size",
          "moe_intermediate_size", "n_routed_experts", "num_experts_per_tok",
          "n_shared_experts", "first_k_dense_replace", "rms_norm_eps",
          "rope_theta", "rope_scaling", "experts_held")
#: the published settings the port's layers implement, and no others
FIXED = dict(q_lora_rank=None, scoring_func="softmax", topk_method="greedy",
             norm_topk_prob=False, routed_scaling_factor=1, n_group=1,
             topk_group=1, moe_layer_freq=1, hidden_act="silu",
             attention_bias=False, tie_word_embeddings=False, seq_aux=True)

widen, alter, reference_batch = gpt.widen, gpt.alter, gpt.reference_batch


def model_of(config: dict) -> dict:
    """The model dict: the ``model`` group with the published widths."""
    import importlib.util

    if importlib.util.find_spec("partiallyshuffledistributedsampler_tpu_torch"
                                ".models.deepseek_v2") is None:
        raise BenchError("missing the port's models/deepseek_v2.py")
    for k, v in FIXED.items():
        if config.get(k) != v:
            raise BenchError(f"{k} = {config.get(k)!r}: the port's "
                             f"DeepSeek-V2 layers implement {v!r} only")
    return dict(config["model"], **{k: config[k] for k in WIDTHS})


def host_rows(config: dict, alloc=np.empty):
    m = config["model"]
    out = gpt.host_rows(config, alloc)
    ids = np.arange(len(out), dtype=np.int64)
    out[:, 0] = ids % m["vocab_size"]
    out[:, 1] = ids // m["vocab_size"]
    return out


def row_check(config: dict, device):
    vocab = config["model"]["vocab_size"]

    def check(b, want):
        rid = b[:, 0] + vocab * b[:, 1]
        j = torch.arange(b.shape[1], device=b.device)
        pat = (rid[:, None] + j) % vocab
        return (rid != want).sum() + (b[:, 2:] != pat[:, 2:]).sum()

    return check


def step_inputs(tokens: torch.Tensor, fed: int) -> tuple:
    return (tokens[:fed],)


def port_config(m: dict):
    """The port's ``DeepSeekV2Config`` of a model dict."""
    from partiallyshuffledistributedsampler_tpu_torch.models import (
        deepseek_v2,
    )

    rs = m["rope_scaling"]
    same = [k for k in WIDTHS if k != "rope_scaling"]
    return deepseek_v2.DeepSeekV2Config(
        **{k: m[k] for k in same}, seq_len=m["seq_len"],
        first_held_expert=m["first_held_expert"],
        aux_loss_alpha=m["aux_loss_alpha"], rope_factor=rs["factor"],
        original_max_position_embeddings=rs[
            "original_max_position_embeddings"],
        beta_fast=rs["beta_fast"], beta_slow=rs["beta_slow"],
        mscale=rs["mscale"], mscale_all_dim=rs["mscale_all_dim"],
        dtype=getattr(torch, m["dtype"]))


def program(m: dict, device):
    from partiallyshuffledistributedsampler_tpu_torch.models import (
        deepseek_v2,
        train,
    )

    cfg = port_config(m)
    with torch.device(device):
        model = deepseek_v2.DeepSeekV2(cfg)

    def make_step(opt, mesh, batch):
        return train.make_deepseek_train_step(cfg, opt, mesh, batch)

    return model, make_step


def _attn_leaves(p: str, m: dict) -> list:
    d, h = m["hidden_size"], m["num_attention_heads"]
    r, rope = m["kv_lora_rank"], m["qk_rope_head_dim"]
    nope, v = m["qk_nope_head_dim"], m["v_head_dim"]
    a = p + "self_attn."
    return [(p + "input_layernorm.weight", (d,), "one"),
            (a + "q_proj.weight", (h * (nope + rope), d), d),
            (a + "kv_a_proj_with_mqa.weight", (r + rope, d), d),
            (a + "kv_a_layernorm.weight", (r,), "one"),
            (a + "kv_b_proj.weight", (h * (nope + v), r), r),
            (a + "o_proj.weight", (d, h * v), h * v),
            (p + "post_attention_layernorm.weight", (d,), "one")]


def leaves(m: dict) -> list:
    d, vocab = m["hidden_size"], m["vocab_size"]
    f, held = m["moe_intermediate_size"], m["experts_held"]
    sf = m["n_shared_experts"] * f
    out = [("embed_tokens.weight", (vocab, d), d)]
    for i in range(m["num_hidden_layers"]):
        p = f"layer{i}."
        out += _attn_leaves(p, m)
        if i < m["first_k_dense_replace"]:
            ff = m["intermediate_size"]
            out += [(p + "mlp.gate_up.weight", (2 * ff, d), d),
                    (p + "mlp.down.weight", (d, ff), ff)]
        else:
            out += [(p + "mlp.gate.weight", (m["n_routed_experts"], d), d),
                    (p + "mlp.experts_gate_up.weight", (held, 2 * f, d), d),
                    (p + "mlp.experts_down.weight", (held, d, f), f),
                    (p + "mlp.shared.gate_up.weight", (2 * sf, d), d),
                    (p + "mlp.shared.down.weight", (d, sf), sf)]
    return out + [("norm.weight", (d,), "one"),
                  ("lm_head.weight", (vocab, d), d)]


def reference_loss(w: dict, m: dict, batch: dict, fp8=False):
    """Mean next-token negative log-likelihood of ``batch["tokens"]`` ``[B,
    T+1]`` plus the balance loss (``reference/deepseek_v2.py``)."""
    return ref.loss(w, m, batch, fp8)


def expert_pair_flops(m: dict) -> int:
    """A train step's FLOPs for one (token, slot) pair on a held expert, as
    the port's model runs them: the gate, up and down products, forward
    (2x) and backward (4x), and the forward again (2x) where the model
    recomputes its held experts in the backward (the port's
    ``RECOMPUTE_EXPERTS``).  ``mfu_pct``'s count (``train_step_flops``)
    leaves the recomputation out."""
    from partiallyshuffledistributedsampler_tpu_torch.models import (
        deepseek_v2,
    )

    passes = 8 if deepseek_v2.RECOMPUTE_EXPERTS else 6
    return passes * 3 * m["hidden_size"] * m["moe_intermediate_size"]


def train_step_flops(m: dict, batch: int) -> float:
    """6 x the product parameters a token passes through x the tokens
    (the held experts at their expected share of the top k: ``k x held /
    E`` experts a token), plus causal attention's two products over the
    T(T+1)/2 query-key pairs of each sequence (the masked half is not
    computed)."""
    d, t, layers = m["hidden_size"], m["seq_len"], m["num_hidden_layers"]
    h, r = m["num_attention_heads"], m["kv_lora_rank"]
    qk = m["qk_nope_head_dim"] + m["qk_rope_head_dim"]
    v, f = m["v_head_dim"], m["moe_intermediate_size"]
    dense = m["first_k_dense_replace"]
    attn = (d * h * qk + d * (r + m["qk_rope_head_dim"])
            + r * h * (m["qk_nope_head_dim"] + v) + h * v * d)
    held_share = (m["num_experts_per_tok"] * m["experts_held"]
                  / m["n_routed_experts"])
    moe = (d * m["n_routed_experts"] + 3 * d * m["n_shared_experts"] * f
           + held_share * 3 * d * f)
    params = (layers * attn + dense * 3 * d * m["intermediate_size"]
              + (layers - dense) * moe + d * m["vocab_size"])
    pairs = t * (t + 1) // 2
    return float(6 * batch * t * params
                 + 6 * batch * pairs * h * (qk + v) * layers)
