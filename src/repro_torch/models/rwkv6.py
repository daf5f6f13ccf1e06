"""RWKV-6 (Finch) blocks on torch tensors: data-dependent decay, the
chunked sub-quadratic form.

Time mix, per head (Dk = Dv = head_dim)::

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    o_t = r_t^T S_{t-1} + (r_t . u . k_t) v_t

with the data-dependent decay ``log w_t = -exp(ww + lora(x_shifted))``,
always negative. A prefill or an uncached forward runs the **chunked**
evaluation (chunk L = ``CHUNK``): within a chunk the terms go through an
[L, L, Dk] decay tensor whose exponents are all at most 0 (cl_{t-1} -
cl_s for s < t), so it is stable by construction; across chunks a Python
loop carries S (the reference's ``lax.scan``). A decode step (T == 1)
runs the exact recurrence.

The reference computes the WKV outside any Pallas kernel, in plain XLA
ops; here it is plain PyTorch, in the reference's dataflow. Its sums run
in another order than XLA's, so the outputs agree with the reference's to
f32 rounding, not bit for bit (tests/test_torch_rwkv6.py states the
tolerance). In a bf16 model the WKV runs in f32 and the group norm in
bf16, with the reference's type promotion made explicit (a bf16 leaf
meeting an f32 operand is cast to f32 first).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init

__all__ = ["rwkv_block_init", "rwkv_time_mix", "rwkv_channel_mix",
           "rwkv_decode_state", "CHUNK"]

CHUNK = 64
_LORA_R = 32


def rwkv_block_init(gen: torch.Generator, d_model: int, d_ff: int,
                    head_dim: int, dtype=torch.float32,
                    device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """The block's parameters with the reference's distributions: the
    projections normal * d_in^-1/2 in ``dtype``; in f32 the mixes ``mu``
    uniform in [0, 1), ``ww`` uniform in [-1, 1.5), the decay LoRA (its
    second factor scaled by 0.01) and the bonus ``u`` normal * 0.3."""
    h = d_model // head_dim
    f32 = dict(dtype=torch.float32, device=device)
    kw = dict(dtype=dtype, device=device)
    return {
        "tm": {
            "mu": torch.rand((5, d_model), generator=gen, **f32),
            "ww": torch.rand(d_model, generator=gen, **f32).mul_(2.5)
            .sub_(1.0),
            "w_lora_a": dense_init(gen, d_model, _LORA_R, **f32),
            "w_lora_b": dense_init(gen, _LORA_R, d_model, scale=0.01, **f32),
            "wr": dense_init(gen, d_model, d_model, **kw),
            "wk": dense_init(gen, d_model, d_model, **kw),
            "wv": dense_init(gen, d_model, d_model, **kw),
            "wg": dense_init(gen, d_model, d_model, **kw),
            "wo": dense_init(gen, d_model, d_model, **kw),
            "u": torch.randn((h, head_dim), generator=gen, **f32).mul_(0.3),
            "gn_scale": torch.ones(d_model, **f32),
        },
        "cm": {
            "mu": torch.rand((2, d_model), generator=gen, **f32),
            "wk": dense_init(gen, d_model, d_ff, **kw),
            "wv": dense_init(gen, d_ff, d_model, **kw),
            "wr": dense_init(gen, d_model, d_model, **kw),
        },
    }


def rwkv_decode_state(batch: int, d_model: int, head_dim: int,
                      dtype=torch.float32, device=None
                      ) -> Dict[str, torch.Tensor]:
    """Zero state: ``S [B, H, hd, hd]`` f32 and the last inputs of the
    time and channel mixes (``tm_prev``, ``cm_prev [B, d]`` in ``dtype``)."""
    h = d_model // head_dim
    return {
        "S": torch.zeros((batch, h, head_dim, head_dim), dtype=torch.float32,
                         device=device),
        "tm_prev": torch.zeros((batch, d_model), dtype=dtype, device=device),
        "cm_prev": torch.zeros((batch, d_model), dtype=dtype, device=device),
    }


def _shift(x: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """x[t - 1] with x[-1] = ``prev`` (or zeros)."""
    pad = torch.zeros_like(x[:, :1]) if prev is None \
        else prev[:, None, :].to(x.dtype)
    return torch.cat([pad, x[:, :-1]], dim=1)


def _heads(x: torch.Tensor, hd: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, d // hd, hd)


def _group_norm(o: torch.Tensor, scale: torch.Tensor, hd: int,
                eps: float = 1e-5) -> torch.Tensor:
    """Per-head normalisation of ``o [B, T, H, hd]``: the mean and the
    (biased) variance computed in f32 and rounded to ``o``'s dtype, as
    ``jnp.mean``/``jnp.var`` compute them for bf16; then [B, T, H * hd]
    times ``scale``."""
    b, t, h, d = o.shape
    of = o.to(torch.float32)
    mean = of.mean(dim=-1, keepdim=True)
    var = ((of - mean) ** 2).mean(dim=-1, keepdim=True)
    o = (o - mean.to(o.dtype)) * torch.rsqrt(var.to(o.dtype) + eps)
    return o.reshape(b, t, h * d) * scale


def _wkv_chunk(S: torch.Tensor, r: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor, logw: torch.Tensor, u: torch.Tensor):
    """One chunk: the carried ``S [B, H, Dk, Dv]``; ``r``/``k``/``v``/
    ``logw [B, L, H, D]`` f32; ``u [H, D]``. Returns (S after the chunk,
    out [B, L, H, Dv])."""
    L = r.shape[1]
    cl = torch.cumsum(logw, dim=1)                     # [B, L, H, D], <= 0
    cl_prev = cl - logw                                # cl_{t-1}
    r_t = r * torch.exp(cl_prev)                       # exp(<= 0)
    o_cross = torch.einsum("blhd,bhdv->blhv", r_t, S)
    # intra-chunk: D[t, s, d] = exp(cl_{t-1, d} - cl_{s, d}), s < t
    expo = cl_prev[:, :, None] - cl[:, None]           # [B, L, L, H, D]
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=r.device),
                     diagonal=-1)
    decay = torch.where(tri[None, :, :, None, None],
                        torch.exp(torch.clamp(expo, max=0.0)),
                        torch.zeros((), dtype=expo.dtype, device=r.device))
    att = torch.einsum("blshd,blshd->blsh", r[:, :, None] * k[:, None],
                       decay)
    diag = (r * u * k).sum(dim=-1)                     # [B, L, H]
    o_intra = torch.einsum("blsh,bshv->blhv", att, v) + diag[..., None] * v
    # S' = diag(exp(cl_L)) S + sum_s diag(exp(cl_L - cl_s)) k_s v_s^T
    k_t = k * torch.exp(cl[:, -1:] - cl)               # exp(<= 0)
    S = S * torch.exp(cl[:, -1])[..., None] + \
        torch.einsum("bshd,bshv->bhdv", k_t, v)
    return S, o_cross + o_intra


def rwkv_time_mix(params, x: torch.Tensor, head_dim: int, *,
                  state: Optional[Dict] = None, chunk: int = CHUNK):
    """x [B, T, D] -> (out [B, T, D], new state or None). T % ``chunk``
    == 0 in the chunked mode (callers pad); a decode step (T == 1 with a
    state) runs the exact recurrence. ``state`` is ``{"S", "tm_prev"}``;
    the new state is returned only when one was given."""
    p = params["tm"]
    b, t, d = x.shape
    hd = head_dim
    h = d // hd
    f32 = torch.float32
    xs = _shift(x, None if state is None else state["tm_prev"])
    mu = p["mu"].to(x.dtype)
    xr, xk, xv, xw, xg = (x + (xs - x) * mu[i] for i in range(5))
    r = _heads(xr @ p["wr"], hd).to(f32)
    k = _heads(xk @ p["wk"], hd).to(f32)
    v = _heads(xv @ p["wv"], hd).to(f32)
    g = xg @ p["wg"]
    dd = torch.tanh(xw.to(f32) @ p["w_lora_a"].to(f32)) \
        @ p["w_lora_b"].to(f32)
    logw = _heads(-torch.exp(p["ww"].to(f32) + dd), hd)    # [B, T, H, D] < 0
    u = p["u"].to(f32)

    if state is not None and t == 1:
        S = state["S"]
        r0, k0, v0 = r[:, 0], k[:, 0], v[:, 0]
        o = torch.einsum("bhd,bhdv->bhv", r0, S) + \
            (r0 * u * k0).sum(dim=-1)[..., None] * v0
        S = S * torch.exp(logw[:, 0])[..., None] + \
            k0[..., None] * v0[..., None, :]
        o = o[:, None]                                  # [B, 1, H, Dv]
        new_state = {"S": S, "tm_prev": x[:, -1]}
    else:
        if t % chunk:
            raise ValueError(f"T={t} not a multiple of chunk={chunk}")
        S = (torch.zeros((b, h, hd, hd), dtype=f32, device=x.device)
             if state is None else state["S"])
        outs = []
        for c in range(t // chunk):
            sl = slice(c * chunk, (c + 1) * chunk)
            S, oc = _wkv_chunk(S, r[:, sl], k[:, sl], v[:, sl], logw[:, sl],
                               u)
            outs.append(oc)
        o = torch.cat(outs, dim=1)
        new_state = None if state is None else {"S": S, "tm_prev": x[:, -1]}

    o = _group_norm(o.to(x.dtype), p["gn_scale"].to(x.dtype), hd)
    out = (o * F.silu(g)) @ p["wo"]
    return out, new_state


def rwkv_channel_mix(params, x: torch.Tensor, *,
                     state: Optional[Dict] = None):
    """x [B, T, D] -> (sigmoid(xr @ wr) * (relu(xk @ wk)^2 @ wv), new
    state ``{"cm_prev"}`` or None), the token shift from ``state``'s
    ``cm_prev``."""
    p = params["cm"]
    xs = _shift(x, None if state is None else state["cm_prev"])
    mu = p["mu"].to(x.dtype)
    xk = x + (xs - x) * mu[0]
    xr = x + (xs - x) * mu[1]
    kk = torch.relu(xk @ p["wk"]) ** 2
    out = torch.sigmoid(xr @ p["wr"]) * (kk @ p["wv"])
    new_state = None if state is None else {"cm_prev": x[:, -1]}
    return out, new_state
