"""Carry parameters and optimizer state between the JAX package's layout
and this package's.

``params_from_numpy`` takes the reference's parameter pytree flattened to
nested dicts and lists of numpy arrays (the caller does the flattening:
this package never imports JAX), with each wire leaf given as a
``(words, format_name)`` pair, and returns this package's parameters on
``device`` (``cuda`` unless the caller names one). The reference stacks
the layers of each scan group on a leading axis, a stack per block of the
group's super-block (``params["groups"][g]["b{i}"]``); here they are split
into one dict per layer, in layer order. The encdec family's two stacks,
``enc`` and ``dec``, become two lists of layer dicts, and vlm's
``embed_media`` and cross blocks, and rwkv6's ``blk`` (``tm``/``cm``)
leaves, carry over as they are. ``params_to_numpy`` goes the other way
(numpy leaves in the reference's stacked layout, wire leaves as
``(words, format_name)``), so
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
from repro_torch.models.transformer import FAMILIES, layer_index, layer_plan

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


def _depth(tree) -> int:
    """The leading (stacked) length of a stacked subtree's first leaf."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return len(tree[0] if isinstance(tree, tuple) else tree)


# the leaves a block of each kind holds beside its norms
_BLOCK_LEAVES = {"self": ("attn", "mlp"), "cross": ("attn", "mlp"),
                 "moe": ("attn", "moe"), "rec": ("rec", "mlp"),
                 "rwkv": ("blk",)}
# the encdec family's stacks: (name, the keys of its block, the config
# field of its depth)
_ENCDEC = (("enc", {"ln1", "ln2", "attn", "mlp"}, "n_enc_layers"),
           ("dec", {"ln1", "ln_x", "ln2", "attn", "xattn", "mlp"},
            "n_layers"))


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not in the port")


def _check_plan(cfg: ModelConfig, tree: Dict[str, Any]) -> None:
    """Raise unless ``tree`` (the reference's layout) holds ``cfg``'s
    blocks: the scan groups of its layer plan, or encdec's two stacks."""
    _check_family(cfg)
    if cfg.family == "encdec":
        if "enc_norm" not in tree or any(
                name not in tree or set(tree[name]) != keys
                or _depth(tree[name]) != getattr(cfg, depth)
                for name, keys, depth in _ENCDEC):
            raise ValueError("expected the encdec stacks enc "
                             f"({cfg.n_enc_layers} layers), dec "
                             f"({cfg.n_layers}) and enc_norm")
        return
    groups = tree["groups"]
    plan = layer_plan(cfg)
    if len(groups) != len(plan) or any(
            set(grp) != {f"b{i}" for i in range(len(pat))}
            or any(not set(_BLOCK_LEAVES[k]) <= set(grp[f"b{i}"])
                   or _depth(grp[f"b{i}"]) != n_rep
                   for i, k in enumerate(pat))
            for grp, (pat, n_rep) in zip(groups, plan)):
        raise ValueError(f"expected the {cfg.family} layer plan {plan}")


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      device=None) -> Dict[str, Any]:
    """Reference params (numpy) of a ported family -> this package's
    params: each scan group's stacked blocks ``groups[g]["b{i}"]`` split
    into one dict a layer and interleaved in layer order (encdec: its
    ``enc`` and ``dec`` stacks split into two lists)."""
    device = resolve_device(device)
    _check_plan(cfg, tree)
    out = {k: _leaf(tree[k], device)
           for k in ("embed_tokens", "unembed", "embed_media") if k in tree}
    for k in ("final_norm", "enc_norm"):
        if k in tree:
            out[k] = {"scale": _leaf(tree[k]["scale"], device)}
    if cfg.family == "encdec":
        for name, _, depth in _ENCDEC:
            out[name] = [_layer(tree[name], r, device)
                         for r in range(getattr(cfg, depth))]
        return out
    groups = tree["groups"]
    out["layers"] = [_layer(groups[g][f"b{i}"], r, device)
                     for g, i, r in layer_index(cfg)]
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
    """This package's params of a ported family -> the reference's layout
    as numpy: each scan group's blocks stacked on a leading axis under
    ``["groups"][g]["b{i}"]`` (encdec: ``enc`` and ``dec`` stacked)."""
    _check_family(cfg)
    out = {k: _host(params[k])
           for k in ("embed_tokens", "unembed", "embed_media") if k in params}
    for k in ("final_norm", "enc_norm"):
        if k in params:
            out[k] = {"scale": _host(params[k]["scale"])}
    if cfg.family == "encdec":
        for name, _, _ in _ENCDEC:
            out[name] = _stack(params[name])
        return out
    where: Dict[tuple, list] = {}
    for j, (g, i, _) in enumerate(layer_index(cfg)):
        where.setdefault((g, i), []).append(params["layers"][j])
    out["groups"] = [{f"b{i}": _stack(where[(g, i)]) for i in range(len(pat))}
                     for g, (pat, _) in enumerate(layer_plan(cfg))]
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
