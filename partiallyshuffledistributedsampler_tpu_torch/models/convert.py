"""Weights carried across from the JAX package's flax modules.

``gpt_params_from_flax`` and ``vit_params_from_flax`` take the flax
parameter tree (nested dicts of numpy arrays, as ``jax.device_get`` of
``init_params``/``init_vit_params`` gives it) and return a ``state_dict``
that the port's ``MiniGPT``/``MiniViT`` load with ``strict=True``.  The
layouts change on the way: a Dense ``kernel`` [in, out] becomes a
``weight`` [out, in], a Conv HWIO kernel becomes OIHW, a LayerNorm
``scale`` becomes ``weight`` and an Embed ``embedding`` becomes
``weight``.  A key the module does not have, or one it lacks, raises.
"""

from __future__ import annotations

import numpy as np
import torch

#: each flax submodule kind: its leaves and how each becomes a torch one
_DENSE = {"kernel": ("weight", lambda a: a.T), "bias": ("bias", None)}
_CONV = {"kernel": ("weight", lambda a: a.transpose(3, 2, 0, 1)),
         "bias": ("bias", None)}
_NORM = {"scale": ("weight", None), "bias": ("bias", None)}
_EMBED = {"embedding": ("weight", None)}
_BLOCK = {"ln1": _NORM, "qkv": _DENSE, "proj": _DENSE, "ln2": _NORM,
          "fc1": _DENSE, "fc2": _DENSE}


def _keys_match(what: str, got, want) -> None:
    got, want = set(got), set(want)
    if got != want:
        raise KeyError(
            f"{what}: unknown keys {sorted(got - want)}, missing keys "
            f"{sorted(want - got)}")


def _module(prefix: str, tree: dict, kind: dict, out: dict) -> None:
    _keys_match(prefix, tree, kind)
    for leaf, (name, layout) in kind.items():
        a = np.asarray(tree[leaf], dtype=np.float32)
        if layout is not None:
            a = layout(a)
        out[f"{prefix}.{name}"] = torch.tensor(np.ascontiguousarray(a))


def _blocks(tree: dict) -> list:
    """The ``block{i}`` names of ``tree``, which must run 0..L-1."""
    names = sorted((k for k in tree if k.startswith("block")),
                   key=lambda k: int(k[5:]) if k[5:].isdigit() else -1)
    want = [f"block{i}" for i in range(len(names))]
    if names != want:
        raise KeyError(f"blocks must be block0..block{len(names) - 1}, got "
                       f"{names}")
    return names


def _convert(tree: dict, top: dict, extra=()) -> dict:
    blocks = _blocks(tree)
    _keys_match("params", tree, [*top, *extra, *blocks])
    out: dict = {}
    for name, kind in top.items():
        _module(name, tree[name], kind, out)
    for name in blocks:
        _keys_match(name, tree[name], _BLOCK)
        for sub, kind in _BLOCK.items():
            _module(f"{name}.{sub}", tree[name][sub], kind, out)
    return out


def gpt_params_from_flax(tree: dict) -> dict:
    """A ``MiniGPT`` state_dict from the JAX package's GPT parameters."""
    return _convert(tree, {"wte": _EMBED, "wpe": _EMBED, "lnf": _NORM,
                           "head": _DENSE})


def vit_params_from_flax(tree: dict) -> dict:
    """A ``MiniViT`` state_dict from the JAX package's ViT parameters."""
    out = _convert(tree, {"patch": _CONV, "wpe": _EMBED, "lnf": _NORM,
                          "head": _DENSE}, extra=("cls",))
    out["cls"] = torch.tensor(np.ascontiguousarray(
        np.asarray(tree["cls"], dtype=np.float32)))
    return out
