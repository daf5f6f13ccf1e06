"""Token-choice top-k MoE with sort-based static-capacity dispatch.

The port of ``repro/models/moe.py``: assignments are sorted by expert id,
positions within each expert's bucket come from a ``searchsorted`` over
the sorted ids, and tokens are scattered into a static ``[E, C, D]``
buffer per group (assignments past an expert's capacity ``C`` are
dropped). The grouped SwiGLU FFN is one batched product over the expert
dim, plain ``torch`` as the reference's ``jnp.einsum`` runs outside any
Pallas kernel. Groups: one per sequence for prefill and training, and one
group of the whole packed batch for a decode step (``T == 1``).

Three places where ``torch`` would otherwise part from JAX:

* ``jax.lax.top_k`` puts the lower expert index first among equal
  logits; ``torch.topk`` promises no order there, so the top k come from
  a stable descending sort;
* ``jnp.argsort`` is stable; so is the sort here (``stable=True``);
* ``.at[tok].add`` sums a token's k contributions in the sorted order
  (ascending expert id) in ``x.dtype``; here each token's k rows are
  gathered in that order and added one after another, a fixed order on
  every device (``index_add_`` on CUDA adds by atomics, in an order that
  changes from run to run).

Nothing here reads a device value back to the host, so a decode step
through it can be captured in a CUDA graph. Aux: the Switch load-balance
term ``E * sum_e fraction_e * prob_e``, returned to the train loss.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.layers import dense_init

__all__ = ["moe_init", "moe_apply", "moe_capacity", "route"]


def moe_capacity(n_tokens: int, n_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    c = int(n_tokens * top_k / n_experts * capacity_factor)
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def moe_init(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             dtype=torch.float32, device=None) -> Dict[str, torch.Tensor]:
    """The router (f32, d^-1/2 scale) and the ``experts_wg``/``w1``
    ``[E, d, f]`` and ``experts_w2 [E, f, d]`` stacks in ``dtype``, with
    the reference's scales."""
    kw = dict(dtype=dtype, device=device)
    return {
        "router": dense_init(gen, d_model, n_experts, dtype=torch.float32,
                             device=device),
        "experts_wg": torch.randn((n_experts, d_model, d_ff), generator=gen,
                                  **kw).mul_(d_model ** -0.5),
        "experts_w1": torch.randn((n_experts, d_model, d_ff), generator=gen,
                                  **kw).mul_(d_model ** -0.5),
        "experts_w2": torch.randn((n_experts, d_ff, d_model), generator=gen,
                                  **kw).mul_(d_ff ** -0.5),
    }


def route(logits: torch.Tensor, top_k: int):
    """``jax.lax.top_k`` over the last dim: (values, indices), the lower
    index first among equal values (a stable descending sort)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :top_k], idx[..., :top_k]


def _dispatch(xt, idx, gates, n_experts: int, c: int):
    """Every group's ``[E, C, D]`` buffer and the combine's metadata,
    each ``[G, S * k]`` in the sorted order: ``sgate``, ``keep``,
    ``dest`` (the buffer row, ``E * C`` when dropped) and ``order`` (the
    sort's permutation of the ``(token, choice)`` assignments)."""
    g, s, d = xt.shape
    k = idx.shape[-1]
    dev = xt.device
    flat_e = idx.reshape(g, s * k).to(torch.int32)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    stok = torch.div(order, k, rounding_mode="floor")  # repeat(arange(s), k)
    sgate = torch.gather(gates.reshape(g, s * k), 1, order)
    starts = torch.searchsorted(
        se, torch.arange(n_experts, dtype=torch.int32,
                         device=dev).expand(g, n_experts).contiguous())
    pos = (torch.arange(s * k, device=dev)
           - torch.gather(starts, 1, se.long()))
    keep = pos < c
    dest = torch.where(keep, se.long() * c + pos,
                       torch.full_like(pos, n_experts * c))
    # the dropped assignments land on an overflow row that is cut off
    buf = torch.zeros((g, n_experts * c + 1, d), dtype=xt.dtype, device=dev)
    rows = torch.gather(xt, 1, stok[..., None].expand(g, s * k, d))
    buf.scatter_(1, dest[..., None].expand(g, s * k, d), rows)
    buf = buf[:, :n_experts * c].reshape(g, n_experts, c, d)
    return buf, (sgate, keep, dest, order)


def _combine(out_buf, meta, s: int, k: int, dtype):
    """Each token's k expert outputs, weighted by their gates, summed in
    the sorted order (ascending expert id) in ``dtype``."""
    sgate, keep, dest, order = meta
    g, n_experts, c, d = out_buf.shape
    flat = out_buf.reshape(g, n_experts * c, d)
    y = torch.gather(flat, 1, torch.clamp(dest, max=n_experts * c - 1)
                     [..., None].expand(g, s * k, d))
    y = torch.where(keep[..., None], y, torch.zeros((), dtype=y.dtype,
                                                    device=y.device))
    y = y * sgate[..., None].to(dtype)
    # sorted position of assignment (token t, choice j) is inv[t * k + j];
    # a token's positions in ascending order are its contributions in the
    # order the reference's scatter-add takes them
    inv = torch.empty_like(order)
    inv.scatter_(1, order, torch.arange(s * k, device=order.device)
                 .expand(g, s * k).contiguous())
    spos = torch.sort(inv.reshape(g, s, k), dim=-1).values
    out = torch.gather(y, 1, spos[..., 0:1].expand(g, s, d))
    for j in range(1, k):
        out = out + torch.gather(y, 1, spos[..., j:j + 1].expand(g, s, d))
    return out


def moe_apply(params, x: torch.Tensor, *, n_experts: int, top_k: int,
              capacity_factor: float = 1.25):
    """x [B, T, D] -> (out [B, T, D], aux f32 scalar), as the reference's
    ``moe_apply``: tokens route within their group (one group per
    sequence for T > 1, one group of the B tokens of a decode step)."""
    b, t, d = x.shape
    g, s = (1, b) if t == 1 else (b, t)
    xt = x.reshape(g, s, d)
    c = moe_capacity(s, n_experts, top_k, capacity_factor)

    logits = (xt @ params["router"].to(x.dtype)).to(torch.float32)
    gate_vals, idx = route(logits, top_k)                   # [G, S, k]
    gates = torch.softmax(gate_vals, dim=-1)

    probs = torch.softmax(logits, dim=-1)
    # one_hot of the top-1 expert, by comparison (no host read of the ids)
    top1 = (idx[..., :1] == torch.arange(n_experts, device=x.device)).to(
        torch.float32)
    aux = n_experts * torch.sum(torch.mean(top1, dim=(0, 1))
                                * torch.mean(probs, dim=(0, 1)))

    buf, meta = _dispatch(xt, idx, gates, n_experts, c)    # [G, E, C, D]
    wg, w1, w2 = (params["experts_wg"].to(x.dtype),
                  params["experts_w1"].to(x.dtype),
                  params["experts_w2"].to(x.dtype))
    # [E, G * C, D]: one batched product per expert
    xe = buf.transpose(0, 1).reshape(n_experts, g * c, d)
    hid = torch.nn.functional.silu(torch.bmm(xe, wg)) * torch.bmm(xe, w1)
    out_e = torch.bmm(hid, w2)                             # [E, G * C, D]
    out_buf = out_e.reshape(n_experts, g, c, d).transpose(0, 1)
    out = _combine(out_buf, meta, s, top_k, x.dtype)       # [G, S, D]
    return out.reshape(b, t, d), aux.to(torch.float32)
