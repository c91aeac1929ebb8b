"""Model FLOPs of one train step, from the configuration's widths alone."""

from __future__ import annotations


def train_step_flops(model: dict, batch: int) -> float:
    """FLOPs of one train step (forward and backward, 3 x the forward): 6 x
    the matmul parameters x the tokens that pass through them, and 12 x B x
    T^2 x d per layer for the two attention products over every query and
    key (a plain attention computes the masked half too).  ``model`` is the
    configuration's ``model`` group; ``kind`` is ``gpt`` or ``vit``."""
    d, layers, f = model["d_model"], model["n_layers"], model["d_ff"]
    block = layers * (4 * d * d + 2 * d * f)
    if model["kind"] == "vit":
        patches = (model["image_size"] // model["patch_size"]) ** 2
        t = patches + 1
        patch = model["channels"] * model["patch_size"] ** 2 * d
        matmul = 6 * batch * (block * t + patch * patches
                              + d * model["num_classes"])
    else:
        t = model["seq_len"]
        matmul = 6 * batch * t * (block + d * model["vocab_size"])
    return float(matmul + 12 * batch * t * t * d * layers)
