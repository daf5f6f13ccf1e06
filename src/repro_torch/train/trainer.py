"""The train step: the port's counterpart of the JAX package's
``make_train_step_gspmd`` on one device.

``make_train_step`` returns ``step(params, opt_state, batch) ->
(params, opt_state, metrics)``: the loss and its gradients (``_grads_fn``:
``loss_fn`` under ``torch.autograd``, with per-block remat and microbatch
accumulation), clipping by the global norm, then AdamW. The step leaves
its inputs as they were. The reference's manual data-parallel step
(shard_map ZeRO-1 with takum-compressed rings) needs the port's
collectives, which are not in the port yet: ``make_train_step_manual``
and ``init_flat_state`` raise.
"""

from __future__ import annotations

import re
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, RuntimeConfig
from repro_torch.core.quant import QuantSpec
from repro_torch.models import model
from repro_torch.optim import adamw as opt
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

__all__ = ["make_train_step", "make_train_step_manual", "init_flat_state",
           "grad_spec_from_quant", "MANUAL_DP_TODO"]

MANUAL_DP_TODO = ("the manual data-parallel step (shard_map ZeRO-1 with "
                  "takum-compressed ring collectives) is not in the port: "
                  "it comes with multi-device training (the rings are in "
                  "repro_torch.dist), ROADMAP.md section 1 item 6")


def grad_spec_from_quant(name: str) -> Optional[QuantSpec]:
    """A gradient-compression name (``takum8``, ``posit16``, ...) as its
    ``QuantSpec``; ``"none"`` or empty: None. The reference reads the
    width from the last two characters, which fails on ``takum8``."""
    if not name or name == "none":
        return None
    m = re.fullmatch(r"(takum|posit)(\d+)", name)
    if m is None:
        raise ValueError(f"unknown gradient compression {name!r}: "
                         f"takum<n> or posit<n>")
    return QuantSpec(fmt=m.group(1), n=int(m.group(2)), scale="none")


def _device_batch(batch, device):
    """A batch's arrays as tensors on ``device`` (token ids as int64)."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if k in ("tokens", "labels"):
            t = t.long()
        out[k] = t.to(device)
    return out


def _grads_fn(cfg: ModelConfig, runtime: RuntimeConfig):
    remat = runtime.remat != "none"

    def value_and_grad(params, batch):
        leaves, treedef = tree_flatten(params)
        for leaf in leaves:
            if not (isinstance(leaf, torch.Tensor)
                    and leaf.is_floating_point()):
                raise TypeError(f"the train step takes float tensor "
                                f"parameters, got {type(leaf).__name__}")
        live = [leaf.detach().requires_grad_(True) for leaf in leaves]
        loss, metrics = model.loss_fn(tree_unflatten(treedef, live), batch,
                                      cfg, remat=remat)
        grads = torch.autograd.grad(loss, live)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, tree_unflatten(treedef, list(grads))

    def grads_of(params, batch):
        if runtime.microbatch and runtime.microbatch > 1:
            k = runtime.microbatch
            mb = {key: v.reshape((k, v.shape[0] // k) + tuple(v.shape[1:]))
                  for key, v in batch.items()}
            g_acc = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device)
                     for p in tree_leaves(params)]
            l_acc = 0.0
            for i in range(k):
                l, _, g = value_and_grad(params,
                                         {key: v[i] for key, v in mb.items()})
                g_acc = [a + b for a, b in zip(g_acc, tree_leaves(g))]
                l_acc = l_acc + l
            g = tree_unflatten(tree_flatten(params)[1],
                               [x / k for x in g_acc])
            loss = l_acc / k
            metrics = {"loss": loss, "xent": loss,
                       "aux": torch.zeros((), dtype=torch.float32,
                                          device=loss.device)}
            return loss, metrics, g
        return value_and_grad(params, batch)

    return grads_of


def make_train_step(cfg: ModelConfig, opt_cfg: opt.AdamWConfig,
                    runtime: RuntimeConfig):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    on the parameters' device; ``batch`` holds numpy arrays or tensors
    ({"tokens", "labels"} [B, T], optionally "loss_mask"). ``metrics``:
    loss, xent, aux and grad_norm as 0-d tensors."""
    grads_of = _grads_fn(cfg, runtime)

    def step(params, opt_state: opt.AdamWState, batch):
        batch = _device_batch(batch, tree_leaves(params)[0].device)
        loss, metrics, grads = grads_of(params, batch)
        grads, gnorm = opt.clip_by_global_norm(grads, opt_cfg.clip_norm)
        params, opt_state = opt.apply_update(params, grads, opt_state,
                                             opt_cfg)
        metrics = dict(metrics, grad_norm=gnorm)
        return params, opt_state, metrics

    return step


def init_flat_state(params, dp: int, npod: int = 1):
    raise NotImplementedError(MANUAL_DP_TODO)


def make_train_step_manual(cfg: ModelConfig, opt_cfg: opt.AdamWConfig,
                           runtime: RuntimeConfig, mesh=None, flat_spec=None,
                           *, compress: Optional[QuantSpec] = None,
                           error_feedback: bool = True):
    raise NotImplementedError(MANUAL_DP_TODO)
