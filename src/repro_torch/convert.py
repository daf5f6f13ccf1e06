"""Carry parameters and optimizer state between the JAX package's layout
and this package's.

``params_from_numpy`` takes the reference's parameter pytree flattened to
nested dicts and lists of numpy arrays (the caller does the flattening:
this package never imports JAX), with each wire leaf given as a
``(words, format_name)`` pair, and returns this package's parameters on
``device`` (``cuda`` unless the caller names one). The reference stacks
the layers of its scan group on a leading axis
(``params["groups"][0]["b0"]``); here they are split into one dict per
layer. ``params_to_numpy`` goes the other way (numpy leaves in the
reference's stacked layout, wire leaves as ``(words, format_name)``), so
gradients compare leaf by leaf and a state trained in one package
resumes in the other; ``adamw_state_from_numpy`` carries the reference's
AdamW moments (``m``, ``v``: trees of the parameters' layout) and step
over.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import WireMatrix

__all__ = ["params_from_numpy", "params_to_numpy", "adamw_state_from_numpy"]


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


def _host(x):
    if isinstance(x, WireMatrix):
        return (_host(x.words), x.spec.name)
    t = x.detach().cpu()
    if t.dtype == torch.uint16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _stack(leaves):
    if isinstance(leaves[0], dict):
        return {k: _stack([leaf[k] for leaf in leaves]) for k in leaves[0]}
    hosts = [_host(leaf) for leaf in leaves]
    if isinstance(hosts[0], tuple):
        return (np.stack([h[0] for h in hosts]), hosts[0][1])
    return np.stack(hosts)


def params_to_numpy(params: Dict[str, Any], cfg: ModelConfig
                    ) -> Dict[str, Any]:
    """This package's dense-family params -> the reference's layout as
    numpy: the layers stacked on a leading axis under
    ``["groups"][0]["b0"]``."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not in the port")
    out = {k: _host(params[k]) for k in ("embed_tokens", "unembed")
           if k in params}
    out["final_norm"] = {"scale": _host(params["final_norm"]["scale"])}
    out["groups"] = [{"b0": _stack(params["layers"])}]
    return out


def adamw_state_from_numpy(m: Dict[str, Any], v: Dict[str, Any], step: int,
                           cfg: ModelConfig, device=None):
    """The reference's AdamW state (``m``/``v`` in its stacked layout, as
    numpy; ``step``) -> this package's ``AdamWState`` on ``device``."""
    from repro_torch.optim.adamw import AdamWState
    device = resolve_device(device)
    return AdamWState(m=params_from_numpy(m, cfg, device),
                      v=params_from_numpy(v, cfg, device),
                      step=torch.tensor(int(step), dtype=torch.int32,
                                        device=device))
