"""Carry the JAX package's parameters over into this package's layout.

``params_from_numpy`` takes the reference's parameter pytree flattened to
nested dicts and lists of numpy arrays (the caller does the flattening:
this package never imports JAX), with each wire leaf given as a
``(words, format_name)`` pair, and returns this package's parameters on
``device`` (``cuda`` unless the caller names one). The reference stacks
the layers of its scan group on a leading axis
(``params["groups"][0]["b0"]``); here they are split into one dict per
layer.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import WireMatrix

__all__ = ["params_from_numpy"]


def _leaf(x, device):
    if isinstance(x, tuple):
        words, fmt = x
        return WireMatrix(torch.from_numpy(np.array(words)).to(device),
                          fmt=fmt)
    return torch.from_numpy(np.array(x)).to(device)


def _layer(tree, i: int, device):
    if isinstance(tree, dict):
        return {k: _layer(v, i, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return _leaf((tree[0][i], tree[1]), device)
    return _leaf(tree[i], device)


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      device=None) -> Dict[str, Any]:
    """Reference dense-family params (numpy) -> this package's params."""
    device = resolve_device(device)
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not in the port")
    groups = tree["groups"]
    if len(groups) != 1 or set(groups[0]) != {"b0"}:
        raise ValueError("expected the dense layer plan: one scan group "
                         "with one block kind")
    stack = groups[0]["b0"]
    out = {k: _leaf(tree[k], device)
           for k in ("embed_tokens", "unembed") if k in tree}
    out["final_norm"] = {"scale": _leaf(tree["final_norm"]["scale"], device)}
    out["layers"] = [_layer(stack, i, device) for i in range(cfg.n_layers)]
    return out
