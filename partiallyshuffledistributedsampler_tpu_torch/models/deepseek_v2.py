"""Third consumer family: a DeepSeek-V2 decoder with multi-head latent
attention (MLA) and a mixture of experts, one GPU's expert-parallel share.

The layer equations follow the DeepSeek-V2 paper (arXiv:2405.04434) and the
published ``modeling_deepseek.py`` of DeepSeek-V2-Lite, with ``h`` the
RMSNorm'd input of a sub-layer:

- MLA without a query compression (``q_lora_rank`` null):
  ``[q_nope_i; q_pe_i] = (W_q h)_i``, ``[c_kv; k_pe] = W_kva h`` and
  ``c_kv <- RMSNorm(c_kv)``, ``[k_nope_i; v_i] = (W_kvb c_kv)_i``; the rope
  parts are rotated by YaRN-scaled RoPE (one ``k_pe`` for every head), and
  causal softmax attention runs at scale ``mscale^2 / sqrt(d_qk)``.
- MoE: ``s = softmax(W_g h)`` over every routed expert in float32, the top
  ``k`` of ``s`` with their weights as they are (``norm_topk_prob`` false,
  ``routed_scaling_factor`` 1), and ``y = Shared(h) + sum over the chosen
  experts that this GPU holds of s_e E_e(h)``, each expert a SwiGLU.
- The sequence-wise balance loss (``seq_aux``): per sequence of length
  ``L``, ``alpha * sum_e f_e P_e`` with ``f_e`` the share of the
  sequence's (token, slot) choices that name ``e``, times ``E / k``, and
  ``P_e`` the mean of ``s_e``; the mean over the sequences, summed over
  the MoE layers.

Expert parallelism: an MoE layer is told which experts it holds
(``first_held_expert`` .. ``+ experts_held``).  The router stays whole, so
every GPU routes over all the experts and computes the balance loss over
all of them; the layer computes only its own experts' part of the result
for the tokens routed to them.  What the absent experts would add is
another GPU's part, and nothing here stands in for it or for the
all-to-all that would carry it.  No token is dropped: there is no
capacity factor, and the layer's buffers are sized for every (token, slot)
pair going to a held expert.

The routed path runs without a host synchronisation: the (token, slot)
pairs are sorted by held expert and each expert's rows are padded to a
multiple of ``ALIGN`` in one buffer, with the offsets found on the card
(``route_plan``); the held experts' products are one grouped GEMM each way
(``torch._grouped_mm`` with device-side offsets); a weighted float32
combine adds each pair's output to its token.  The buffer is sized for the
worst case, every slot of every token on a held expert, and no host reads
how much of it is filled, so (``RECOMPUTE_EXPERTS``) the gather, the
grouped GEMMs and the combine run under ``torch.utils.checkpoint``: the
backward recomputes them from the layer's input and keeps none of the
buffer's rows, as MoE trainings recompute their expert MLPs.  The held
experts' products then run three times a step: forward, again in the
backward, and the backward's own.

The work around the two GEMMs is six kernels (``ops/cuda_kernel.py``
``moe_*``, ``csrc/moe_kernels.cu``) in three autograd Functions, the
gather, the SwiGLU and the combine, each with its backward: they read the
offsets and the counts on the card and touch only the rows that hold a
pair.  Each group's padding rows get exact zeros (the gather's rows, the
SwiGLU's output and both gradients that enter the GEMMs' backward), so
they pass through the grouped GEMMs adding nothing to any weight's
gradient; the rows at or past the last offset, which the grouped GEMM
never writes, are never read.  For CPU tensors ``ops/cuda_kernel.py`` runs
each kernel's plain PyTorch version, which the card's kernels are held to.

Conventions are ``gpt.py``'s: parameters in float32, each layer computing
in ``cfg.dtype`` through explicit casts, norms taking their statistics in
float32, the router's softmax and the loss in float32.  The LM head is an
untied, bias-free product in ``cfg.dtype`` whose logits go to the float32
loss.  Attention runs through ``F.scaled_dot_product_attention`` (causal),
with values at their own head size.

Telemetry.  Traced (``telemetry``), a forward records these spans, each
with its device interval on the card and none in the backward (the
recomputation records nothing):

- ``attn.mla``: a layer's latent attention with its input RMSNorm
  (projections, rope, SDPA, output projection);
- ``moe.route``: an MoE layer's float32 router, top k, balance loss, and
  ``route_plan``'s sort and offsets;
- ``moe.experts``: the held experts' gather, grouped GEMMs and SwiGLU
  (on the card the ``moe_gather`` and ``moe_swiglu`` kernels);
- ``moe.combine``: the weighted float32 combine into the tokens (on the
  card the ``moe_combine`` kernel);
- ``moe.shared``: the shared experts' SwiGLU and its sum with the routed
  part.

Each MoE layer keeps three int64 counters on its device, added to in the
step with no host synchronisation: ``MoE.expert_tokens``
(``[experts_held]``, the (token, slot) pairs each held expert took),
``MoE.tokens_dropped`` (the pairs routed to a held expert that found no
row of the buffer: 0 by construction, a check), both in pairs, and
``MoE.rows_filled`` (a scalar, in rows: the buffer's rows below the last
offset, filled and padding, summed over the layer's forwards; over
forwards times the buffer's rows it is the share of the buffer that the
kernels touch).  ``moe_counters`` reads every layer's counters in one
copy from the card; ``reset_moe_counters`` zeroes them there without a
synchronisation.
``MoE.last_routes`` holds the last forward's top-k expert ids (``[tokens,
k]``, no gradient).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from torch.utils.checkpoint import checkpoint

from ..ops import cuda_kernel as ck
from ..telemetry import NULL_SPAN
from ..telemetry import span as _span
from .gpt import Embed, init_module_

#: rows of each held expert's group in the grouped GEMM's buffer are
#: padded to a multiple of this (16 bf16 rows: whole 32-byte sectors)
ALIGN = 16
#: the held experts' gather, products and combine are recomputed in the
#: backward instead of keeping the worst-case buffer's rows (the
#: benchmark's count of the experts' work reads it)
RECOMPUTE_EXPERTS = True


def _no_span(*_args, **_kw):
    return NULL_SPAN


@dataclasses.dataclass(frozen=True)
class DeepSeekV2Config:
    """Widths under the published configuration's names; the defaults are
    a tiny model for the CPU tests.  ``rope_*``, ``beta_*`` and
    ``mscale*`` are the published ``rope_scaling`` (YaRN) group."""

    vocab_size: int = 256
    seq_len: int = 32
    hidden_size: int = 64
    num_hidden_layers: int = 3
    num_attention_heads: int = 4
    kv_lora_rank: int = 32
    qk_nope_head_dim: int = 16
    qk_rope_head_dim: int = 16
    v_head_dim: int = 16
    intermediate_size: int = 128
    moe_intermediate_size: int = 32
    n_routed_experts: int = 8
    num_experts_per_tok: int = 2
    n_shared_experts: int = 1
    first_k_dense_replace: int = 1
    first_held_expert: int = 0
    experts_held: int = 8
    aux_loss_alpha: float = 0.001
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_factor: float = 40.0
    original_max_position_embeddings: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 0.707
    mscale_all_dim: float = 0.707
    dtype: torch.dtype = torch.bfloat16  # activations; params stay f32

    def __post_init__(self):
        lo, held = self.first_held_expert, self.experts_held
        if not (0 <= lo and 1 <= held and lo + held <= self.n_routed_experts):
            raise ValueError(
                f"held experts [{lo}, {lo + held}) must lie in [0, "
                f"{self.n_routed_experts})")
        if not 1 <= self.num_experts_per_tok <= self.n_routed_experts:
            raise ValueError(
                f"num_experts_per_tok {self.num_experts_per_tok} not in [1, "
                f"{self.n_routed_experts}]")

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


def yarn_mscale(scale: float, mscale: float) -> float:
    """YaRN's attention temperature: ``0.1 * mscale * ln(scale) + 1``."""
    return 0.1 * mscale * math.log(scale) + 1.0 if scale > 1 else 1.0


def yarn_inv_freq(cfg: DeepSeekV2Config) -> torch.Tensor:
    """The rope dimensions' float32 frequencies: the original ones below
    the correction range, divided by the factor above it, a linear ramp
    between (the published ``DeepseekV2YarnRotaryEmbedding``)."""
    dim, base = cfg.qk_rope_head_dim, cfg.rope_theta
    exps = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    extra = 1.0 / base ** exps
    inter = 1.0 / (cfg.rope_factor * base ** exps)

    def corr(rot):
        return (dim * math.log(cfg.original_max_position_embeddings
                               / (rot * 2 * math.pi))) / (2 * math.log(base))

    lo = max(math.floor(corr(cfg.beta_fast)), 0)
    hi = min(math.ceil(corr(cfg.beta_slow)), dim - 1)
    if lo == hi:
        hi += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - lo)
            / (hi - lo)).clamp(0, 1)
    keep = 1.0 - ramp
    return inter * (1 - keep) + extra * keep


def rope_tables(cfg: DeepSeekV2Config) -> tuple:
    """``(cos, sin)`` float32 ``[seq_len, rope_dim]`` (the frequencies
    repeated over the two halves), times YaRN's mscale ratio (1 when
    ``mscale == mscale_all_dim``)."""
    t = torch.arange(cfg.seq_len, dtype=torch.float32)
    freqs = torch.outer(t, yarn_inv_freq(cfg))
    emb = torch.cat((freqs, freqs), dim=-1)
    m = (yarn_mscale(cfg.rope_factor, cfg.mscale)
         / yarn_mscale(cfg.rope_factor, cfg.mscale_all_dim))
    return emb.cos() * m, emb.sin() * m


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """The published rotation of ``x`` ``[B, H, T, d]``: its interleaved
    pairs are gathered into halves, then ``x cos + rotate_half(x) sin``,
    in float32, cast back."""
    b, h, t, d = x.shape
    xf = x.float().view(b, h, t, d // 2, 2).transpose(4, 3).reshape(b, h, t, d)
    rot = torch.cat((-xf[..., d // 2:], xf[..., :d // 2]), dim=-1)
    return (xf * cos + rot * sin).to(x.dtype)


class Linear(nn.Module):
    """A bias-free ``[out, in]`` projection in the compute dtype."""

    def __init__(self, d_in: int, d_out: int) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.fan_in = d_in  # lecun-normal initialisation

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return F.linear(x.to(dtype), self.weight.to(dtype))


class Experts(nn.Module):
    """The held experts' weights of one projection, ``[held, out, in]``."""

    def __init__(self, held: int, d_in: int, d_out: int) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.empty(held, d_out, d_in))
        self.fan_in = d_in


class RMSNorm(nn.Module):
    """Statistics and scale in float32, the result cast to the compute
    dtype."""

    def __init__(self, d: int, eps: float) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.eps = eps

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        xf = x.float()
        norm = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
        return (norm * self.weight).to(dtype)


class SwiGLU(nn.Module):
    """``down(silu(gate(x)) * up(x))``, gate and up as one product."""

    def __init__(self, d: int, f: int) -> None:
        super().__init__()
        self.f = f
        self.gate_up = Linear(d, 2 * f)
        self.down = Linear(f, d)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        g, u = self.gate_up(x, dtype).split(self.f, dim=-1)
        return self.down(F.silu(g) * u, dtype)


class MLA(nn.Module):
    """Multi-head latent attention (no query compression)."""

    def __init__(self, cfg: DeepSeekV2Config) -> None:
        super().__init__()
        self.cfg = cfg
        d, heads = cfg.hidden_size, cfg.num_attention_heads
        self.q_proj = Linear(d, heads * cfg.qk_head_dim)
        self.kv_a_proj_with_mqa = Linear(d, cfg.kv_lora_rank
                                         + cfg.qk_rope_head_dim)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, cfg.rms_norm_eps)
        self.kv_b_proj = Linear(cfg.kv_lora_rank,
                                heads * (cfg.qk_nope_head_dim
                                         + cfg.v_head_dim))
        self.o_proj = Linear(heads * cfg.v_head_dim, d)
        m = yarn_mscale(cfg.rope_factor, cfg.mscale_all_dim)
        self.scale = cfg.qk_head_dim ** -0.5 * m * m

    def forward(self, h: torch.Tensor, cos, sin) -> torch.Tensor:
        c, dt = self.cfg, self.cfg.dtype
        B, T, _ = h.shape
        H, nope, rope = c.num_attention_heads, c.qk_nope_head_dim, \
            c.qk_rope_head_dim
        q = self.q_proj(h, dt).view(B, T, H, c.qk_head_dim).transpose(1, 2)
        q_nope, q_pe = q.split([nope, rope], dim=-1)
        ckv, k_pe = self.kv_a_proj_with_mqa(h, dt).split(
            [c.kv_lora_rank, rope], dim=-1)
        kv = self.kv_b_proj(self.kv_a_layernorm(ckv, dt), dt)
        k_nope, v = kv.view(B, T, H, nope + c.v_head_dim).transpose(
            1, 2).split([nope, c.v_head_dim], dim=-1)
        q = torch.cat([q_nope, apply_rope(q_pe, cos, sin)], dim=-1)
        k_pe = apply_rope(k_pe.view(B, 1, T, rope), cos, sin)
        k = torch.cat([k_nope, k_pe.expand(B, H, T, rope)], dim=-1)
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                             scale=self.scale)
        return self.o_proj(out.transpose(1, 2).reshape(
            B, T, H * c.v_head_dim), dt)


def route_plan(idx: torch.Tensor, first: int, held: int) -> dict:
    """The rows of the held experts' grouped GEMM, from the top-k expert
    ids ``idx`` ``[N, k]``, on their device and with no synchronisation.

    The N*k (token, slot) pairs are sorted by held expert (pairs of other
    experts last); expert g's pairs take rows ``[ends[g] - padded[g],
    ends[g] - padded[g] + counts[g])`` of a buffer of ``N*k + held *
    (ALIGN - 1)`` rows, each group padded to a multiple of ``ALIGN``.
    Returns ``row`` (int32 ``[N*k]``, the row of each pair, -1 for a pair
    of an expert held elsewhere), ``rows`` (the buffer's rows), ``ends``
    (int32, the grouped GEMM's offsets), ``counts`` (int64 pairs a held
    expert) and ``dropped`` (held pairs that found no row of their own:
    0)."""
    n_pairs = idx.numel()
    local = idx.reshape(-1) - first
    key = torch.where((local >= 0) & (local < held), local, held)
    order = torch.argsort(key, stable=True)
    counts = torch.zeros(held + 1, dtype=torch.int64, device=idx.device)
    counts.scatter_add_(0, key, torch.ones_like(key))
    starts = torch.cumsum(counts, 0) - counts  # in sorted order
    padded = (counts[:held] + ALIGN - 1) // ALIGN * ALIGN
    ends = torch.cumsum(padded, 0)
    rows = n_pairs + held * (ALIGN - 1)
    sk = key[order]
    in_group = torch.arange(n_pairs, device=idx.device) - starts[sk]
    g = sk.clamp(max=held - 1)
    dest = torch.where(sk < held, ends[g] - padded[g] + in_group, rows)
    # every pair of an expert held elsewhere lands on one row past the end
    taken = torch.zeros(rows + 1, dtype=torch.bool,
                        device=idx.device).index_fill_(0, dest, True)[:rows]
    row = torch.empty(n_pairs, dtype=torch.int32, device=idx.device)
    row.scatter_(0, order, torch.where(sk < held, dest, -1).to(torch.int32))
    return dict(row=row, rows=rows, ends=ends.to(torch.int32),
                counts=counts[:held], dropped=counts[:held].sum() - taken.sum())


class MoE(nn.Module):
    """The router over every routed expert, the held experts, the shared
    experts as one SwiGLU, and the layer's counters."""

    def __init__(self, cfg: DeepSeekV2Config) -> None:
        super().__init__()
        self.cfg = cfg
        d, f = cfg.hidden_size, cfg.moe_intermediate_size
        self.gate = Linear(d, cfg.n_routed_experts)  # used in float32
        self.experts_gate_up = Experts(cfg.experts_held, d, 2 * f)
        self.experts_down = Experts(cfg.experts_held, f, d)
        self.shared = SwiGLU(d, cfg.n_shared_experts * f)
        #: (token, slot) pairs each held expert took, and held pairs that
        #: found no row; int64 on the layer's device
        self.register_buffer("expert_tokens", torch.zeros(
            cfg.experts_held, dtype=torch.int64), persistent=False)
        self.register_buffer("tokens_dropped", torch.zeros(
            (), dtype=torch.int64), persistent=False)
        #: rows of the buffer below its last offset, summed over forwards
        self.register_buffer("rows_filled", torch.zeros(
            (), dtype=torch.int64), persistent=False)
        #: the last forward's top-k expert ids ``[N, k]`` (no gradient)
        self.last_routes = None

    def balance_loss(self, scores: torch.Tensor, idx: torch.Tensor,
                     B: int) -> torch.Tensor:
        """``alpha * sum_e f_e P_e`` a sequence, averaged over ``B``."""
        c = self.cfg
        E, k = c.n_routed_experts, c.num_experts_per_tok
        L = scores.shape[0] // B
        chosen = torch.zeros(B, E, device=scores.device).scatter_add_(
            1, idx.view(B, L * k), torch.ones(B, L * k, device=scores.device))
        f = chosen / (L * k / E)
        return c.aux_loss_alpha * (f * scores.view(B, L, E).mean(1)).sum(
            1).mean()

    def _routed(self, x, w, plan: dict, first: list) -> torch.Tensor:
        """The held experts' part of the result, float32 ``[N, D]``: each
        row's token gathered, the grouped GEMMs, the weighted combine
        (``routed_kernels``).  Where ``RECOMPUTE_EXPERTS``, recomputed in
        the backward (``checkpoint``), which keeps none of the buffer's
        rows; the spans are recorded on the first call."""
        span = _span if first[0] else _no_span
        first[0] = False
        return routed_kernels(self, x, w, plan, span)

    def forward(self, h: torch.Tensor) -> tuple:
        c, dt = self.cfg, self.cfg.dtype
        B, T, D = h.shape
        x = h.reshape(B * T, D)
        dev = h.device
        with _span("moe.route", device_ms=dev):
            scores = F.linear(x.float(), self.gate.weight).softmax(-1)
            w, idx = scores.topk(c.num_experts_per_tok, dim=-1)
            self.last_routes = idx.detach()
            aux = self.balance_loss(scores, idx, B)
            with torch.no_grad():
                plan = route_plan(idx, c.first_held_expert, c.experts_held)
                self.expert_tokens += plan["counts"]
                self.tokens_dropped += plan["dropped"]
                self.rows_filled += plan["ends"][-1]
        args = (x, w, plan, [True])
        routed = (checkpoint(self._routed, *args, use_reentrant=False,
                             preserve_rng_state=False)
                  if RECOMPUTE_EXPERTS else self._routed(*args))
        with _span("moe.shared", device_ms=dev):
            out = routed.to(dt) + self.shared(x, dt)
        return out.view(B, T, D), aux


def routed_kernels(moe: MoE, x, w, plan: dict,
                   span=_no_span) -> torch.Tensor:
    """``MoE._routed``: the gather, the grouped GEMMs with the SwiGLU
    between them and the combine, through the ``moe_*`` kernels, which
    touch only the filled rows (``ops/cuda_kernel.py`` runs their plain
    versions for CPU tensors)."""
    row, ends, counts = plan["row"], plan["ends"], plan["counts"]
    dt = moe.cfg.dtype
    with span("moe.experts", device_ms=x.device):
        rows = _Gather.apply(x, row, ends, counts, plan["rows"])
        gu = torch._grouped_mm(rows, moe.experts_gate_up.weight.to(
            dt).transpose(-2, -1), offs=ends)
        y = torch._grouped_mm(_SwiGLU.apply(gu, ends, counts),
                              moe.experts_down.weight.to(dt).transpose(
                                  -2, -1), offs=ends)
    with span("moe.combine", device_ms=x.device):
        return _Combine.apply(y, w, row, ends, counts)


class _Gather(torch.autograd.Function):
    """The buffer's rows from the tokens (``ck.moe_gather``); the backward
    sums each token's rows (``ck.moe_gather_backward``)."""

    @staticmethod
    def forward(ctx, x, row, ends, counts, rows: int):
        ctx.save_for_backward(row)
        ctx.tokens = x.shape[0]
        return ck.moe_gather(x, row, ends, counts, rows)

    @staticmethod
    def backward(ctx, drows):
        (row,) = ctx.saved_tensors
        return (ck.moe_gather_backward(drows.contiguous(), row, ctx.tokens),
                None, None, None, None)


class _SwiGLU(torch.autograd.Function):
    """``silu(g) * u`` of the buffer's rows ``[g | u]`` (``ck.moe_swiglu``,
    ``ck.moe_swiglu_backward``)."""

    @staticmethod
    def forward(ctx, gu, ends, counts):
        ctx.save_for_backward(gu, ends, counts)
        return ck.moe_swiglu(gu, ends, counts)

    @staticmethod
    def backward(ctx, dh):
        gu, ends, counts = ctx.saved_tensors
        return (ck.moe_swiglu_backward(gu, dh.contiguous(), ends, counts),
                None, None)


class _Combine(torch.autograd.Function):
    """The weighted float32 sum of each token's rows (``ck.moe_combine``);
    the backward gives the rows' and the weights' gradients
    (``ck.moe_combine_backward``)."""

    @staticmethod
    def forward(ctx, y, w, row, ends, counts):
        ctx.save_for_backward(y, w, row, ends, counts)
        return ck.moe_combine(y, w, row)

    @staticmethod
    def backward(ctx, dout):
        dy, dw = ck.moe_combine_backward(dout.contiguous(), *ctx.saved_tensors)
        return dy, dw, None, None, None


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DeepSeekV2Config, moe: bool) -> None:
        super().__init__()
        self.cfg = cfg
        d, eps = cfg.hidden_size, cfg.rms_norm_eps
        self.input_layernorm = RMSNorm(d, eps)
        self.self_attn = MLA(cfg)
        self.post_attention_layernorm = RMSNorm(d, eps)
        self.mlp = MoE(cfg) if moe else SwiGLU(d, cfg.intermediate_size)

    def forward(self, x: torch.Tensor, cos, sin) -> tuple:
        dt = self.cfg.dtype
        with _span("attn.mla", device_ms=x.device):
            x = x + self.self_attn(self.input_layernorm(x, dt), cos, sin)
        h = self.post_attention_layernorm(x, dt)
        if isinstance(self.mlp, MoE):
            y, aux = self.mlp(h)
            return x + y, aux
        return x + self.mlp(h, dt), None


class DeepSeekV2(nn.Module):
    """The decoder: a token embedding, ``num_hidden_layers`` layers
    (``layer0`` ...; the first ``first_k_dense_replace`` dense), a final
    RMSNorm and an untied head.  ``forward`` gives ``(logits, aux)``: the
    logits in the compute dtype and the balance loss of every MoE layer,
    summed, in float32."""

    def __init__(self, cfg: DeepSeekV2Config) -> None:
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = Embed(cfg.vocab_size, cfg.hidden_size)
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"layer{i}", DecoderLayer(
                cfg, moe=i >= cfg.first_k_dense_replace))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size)
        cos, sin = rope_tables(cfg)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    def layers(self) -> list:
        return [getattr(self, f"layer{i}")
                for i in range(self.cfg.num_hidden_layers)]

    def moe_layers(self) -> list:
        return [layer.mlp for layer in self.layers()
                if isinstance(layer.mlp, MoE)]

    def forward(self, tokens: torch.Tensor) -> tuple:
        dt, T = self.cfg.dtype, tokens.shape[1]
        cos, sin = self.rope_cos[:T], self.rope_sin[:T]
        x = self.embed_tokens(tokens, dt)
        aux = torch.zeros((), device=tokens.device)
        for layer in self.layers():
            x, a = layer(x, cos, sin)
            if a is not None:
                aux = aux + a
        return self.lm_head(self.norm(x, dt), dt), aux


def init_deepseek_params(cfg: DeepSeekV2Config,
                         generator: torch.Generator) -> DeepSeekV2:
    """A ``DeepSeekV2`` with float32 parameters on the host: lecun-normal
    projections and expert weights, an embedding of variance 1/d, norms at
    one."""
    model = DeepSeekV2(cfg)
    init_module_(model, generator)
    return model


def moe_counters(model: DeepSeekV2) -> dict:
    """The MoE layers' counters, read from the card in one copy:
    ``expert_tokens`` (``[moe layers][held experts]``, the (token, slot)
    pairs each held expert took since the last reset), ``tokens_dropped``
    (held pairs that found no row, summed over the layers; 0 unless the
    routing is at fault), both in (token, slot) pairs, and ``rows_filled``
    (``[moe layers]``, in rows: the buffer's rows below its last offset
    over the forwards since the last reset)."""
    layers = model.moe_layers()
    if not layers:
        return dict(expert_tokens=[], tokens_dropped=0, rows_filled=[])
    read = torch.cat([torch.stack([m.expert_tokens for m in layers]),
                      torch.stack([torch.stack([m.tokens_dropped,
                                                m.rows_filled])
                                   for m in layers])], dim=1).cpu()
    return dict(expert_tokens=read[:, :-2].tolist(),
                tokens_dropped=int(read[:, -2].sum()),
                rows_filled=read[:, -1].tolist())


def reset_moe_counters(model: DeepSeekV2) -> None:
    """Zero every MoE layer's counters on their device, without a
    synchronisation: ``expert_tokens`` and ``tokens_dropped`` (in (token,
    slot) pairs) and ``rows_filled`` (in rows)."""
    for m in model.moe_layers():
        m.expert_tokens.zero_()
        m.tokens_dropped.zero_()
        m.rows_filled.zero_()
