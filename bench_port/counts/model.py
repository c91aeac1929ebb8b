"""Model FLOPs of one train step, from the configuration's widths alone,
by the model's kind (``kinds/<kind>.py``)."""

from __future__ import annotations

from bench_port import kinds


def block_params(model: dict) -> int:
    """The matmul parameters of the transformer blocks: q, k, v, the
    projection and the two MLP layers of each."""
    d, f = model["d_model"], model["d_ff"]
    return model["n_layers"] * (4 * d * d + 2 * d * f)


def attention_flops(model: dict, batch: int, t: int) -> int:
    """12 x B x T^2 x d per layer for the two attention products over every
    query and key (a plain attention computes the masked half too)."""
    return 12 * batch * t * t * model["d_model"] * model["n_layers"]


def train_step_flops(model: dict, batch: int) -> float:
    """FLOPs of one rank's train step (forward and backward, 3 x the
    forward): 6 x the matmul parameters x the tokens that pass through them,
    and the attention products (``attention_flops``).  ``model`` is the
    configuration's ``model`` group."""
    return kinds.load(model["kind"]).train_step_flops(model, batch)
