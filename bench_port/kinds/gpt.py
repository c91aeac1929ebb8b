"""GPT (``model.kind`` "gpt"): token rows and the port's ``MiniGPT`` with
``make_train_step``, GPT-2's plain reference, its leaves and FLOPs
(``kinds/__init__.py`` gives the contract).

A token row holds its id in its first two tokens (id % ID_BASE, id //
ID_BASE) and (id + j) % vocab at token j; rows are served as uint16 and
widened to int64 on the card."""

from __future__ import annotations

import numpy as np
import torch

from bench_port import kinds, weights
from bench_port.counts import model as model_counts
from bench_port.reference import models as ref

ID_BASE = 50_000


def host_rows(config: dict, alloc=np.empty):
    m = config["model"]
    rows, width, vocab = config["host_rows"], m["seq_len"] + 1, m["vocab_size"]
    tmpl = (np.arange(vocab + width, dtype=np.int64) % vocab).astype(
        np.uint16)
    out = alloc((rows, width), np.uint16)
    kinds.fill(out, tmpl, lambda r: r % vocab)
    ids = np.arange(rows, dtype=np.int64)
    out[:, 0] = ids % ID_BASE
    out[:, 1] = ids // ID_BASE
    return out


def widen(b: torch.Tensor) -> torch.Tensor:
    """A served uint16 batch as int64 tokens, combined from its bytes on
    the card (uint16 tensors take few operations)."""
    b8 = b.contiguous().view(torch.uint8).to(torch.int64)
    return b8[..., 0::2] + 256 * b8[..., 1::2]


def alter(tokens: torch.Tensor) -> None:
    tokens[0, 5] += 1


def row_check(config: dict, device):
    vocab = config["model"]["vocab_size"]

    def check(b, want):
        rid = b[:, 0] + ID_BASE * b[:, 1]
        j = torch.arange(b.shape[1], device=b.device)
        pat = (rid[:, None] + j) % vocab
        return (rid != want).sum() + (b[:, 2:] != pat[:, 2:]).sum()

    return check


def step_inputs(tokens: torch.Tensor, fed: int) -> tuple:
    return (tokens[:fed],)


def program(m: dict, device):
    from partiallyshuffledistributedsampler_tpu_torch.models import gpt, train

    widths = {k: m[k] for k in m if k not in ("kind", "dtype")}
    with torch.device(device):
        cfg = gpt.GPTConfig(dtype=getattr(torch, m["dtype"]), **widths)
        model = gpt.MiniGPT(cfg)

    def make_step(opt, mesh, batch):
        return train.make_train_step(cfg, opt, mesh, batch)

    return model, make_step


def reference_batch(data: np.ndarray, ids: np.ndarray, device) -> dict:
    tok = torch.from_numpy(data[ids].astype(np.int64))
    return {"tokens": tok.to(device)}


def leaves(m: dict) -> list:
    d = m["d_model"]
    return weights.transformer_leaves(
        m, [("wte.weight", (m["vocab_size"], d), d),
            ("wpe.weight", (m["seq_len"], d), d)], m["vocab_size"])


def reference_loss(w: dict, m: dict, batch: dict, fp8=False):
    """Mean next-token negative log-likelihood of ``batch["tokens"]``
    ``[B, T+1]``."""
    tok = batch["tokens"]
    return ref.nll(ref.gpt_logits(w, m, tok[:, :-1], fp8), tok[:, 1:])


def train_step_flops(m: dict, batch: int) -> float:
    t = m["seq_len"]
    matmul = 6 * batch * t * (model_counts.block_params(m)
                              + m["d_model"] * m["vocab_size"])
    return float(matmul + model_counts.attention_flops(m, batch, t))
