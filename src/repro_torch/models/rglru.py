"""RG-LRU recurrent block (RecurrentGemma / Griffin) on torch tensors.

Per channel, ``h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)`` with
``a_t = exp(-c * softplus(lam) * sigmoid(x_t @ w_a))`` (c = 8) and the
input gate ``i_t = sigmoid(x_t @ w_x)``; ``x`` is the input projection
after a depthwise causal convolution of ``CONV_K`` taps, and the output
is ``(h * gelu(x @ w_in_g)) @ w_out``.

The reference runs the recurrence as ``jax.lax.associative_scan`` (XLA,
not a Pallas kernel). Here it is a log-depth scan of the same combine
(Hillis-Steele: ``ceil(log2 T)`` rounds of elementwise products), in
plain PyTorch. Its products meet in another order than XLA's, so ``h``
agrees with the reference's to f32 rounding, not bit for bit
(tests/test_torch_rglru.py states the tolerance). A decode step carries
``h`` (f32) and the convolution's last ``CONV_K - 1`` inputs.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.models.layers import dense_init, gelu

__all__ = ["CONV_K", "rglru_block_init", "rglru_block_apply",
           "rglru_decode_state"]

CONV_K = 4
_C = 8.0


def rglru_block_init(gen: torch.Generator, d_model: int, lru_width: int,
                     dtype=torch.float32, device=None) -> Dict[str, torch.Tensor]:
    """The block's parameters with the reference's scales: the dense
    matrices normal * d_in^-1/2, ``conv [CONV_K, C]`` normal * 0.1, ``lam
    [C]`` f32 uniform in [2, 6) (so ``a`` lies in about (0.9, 0.999) at a
    gate of 0.5)."""
    kw = dict(dtype=dtype, device=device)
    return {
        "w_in_x": dense_init(gen, d_model, lru_width, **kw),
        "w_in_g": dense_init(gen, d_model, lru_width, **kw),
        "conv": torch.randn((CONV_K, lru_width), generator=gen, **kw)
        .mul_(0.1),
        "w_a": dense_init(gen, lru_width, lru_width, **kw),
        "w_x": dense_init(gen, lru_width, lru_width, **kw),
        "lam": torch.rand(lru_width, generator=gen, dtype=torch.float32,
                          device=device).mul_(4.0).add_(2.0),
        "w_out": dense_init(gen, lru_width, d_model, **kw),
    }


def _conv1d_causal(x: torch.Tensor, kernel: torch.Tensor,
                   state: Optional[torch.Tensor]):
    """Depthwise causal convolution: x [B, T, C], kernel [CONV_K, C],
    ``state`` the previous ``CONV_K - 1`` inputs [B, CONV_K - 1, C] (None:
    zeros). Returns (out [B, T, C], the new state). The taps add in the
    reference's order."""
    b, t, c = x.shape
    pad = (torch.zeros((b, CONV_K - 1, c), dtype=x.dtype, device=x.device)
           if state is None else state.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)
    out = xp[:, 0:t] * kernel[0]
    for i in range(1, CONV_K):
        out = out + xp[:, i:i + t] * kernel[i]
    return out, xp[:, -(CONV_K - 1):]


def _scan(a: torch.Tensor, bx: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + bx_t along dim 1 (h_{-1} = 0), by the
    associative combine (a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2) in
    ceil(log2 T) rounds."""
    t = a.shape[1]
    step = 1
    while step < t:
        b_prev = torch.nn.functional.pad(bx[:, :-step], (0, 0, step, 0))
        a_prev = torch.nn.functional.pad(a[:, :-step], (0, 0, step, 0),
                                         value=1.0)
        bx = a * b_prev + bx
        a = a * a_prev
        step *= 2
    return bx


def rglru_decode_state(batch: int, lru_width: int, dtype=torch.float32,
                       device=None) -> Dict[str, torch.Tensor]:
    """A sequence's state: ``h [B, C]`` f32 and ``conv [B, CONV_K - 1, C]``
    in the compute dtype, zeros."""
    return {"h": torch.zeros((batch, lru_width), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, CONV_K - 1, lru_width), dtype=dtype,
                                device=device)}


def rglru_block_apply(params, x: torch.Tensor, *,
                      state: Optional[Dict[str, torch.Tensor]] = None):
    """x [B, T, D] -> (out [B, T, D], new state or None). With ``state``
    (a prefill or decode call) the carried ``h`` enters through the first
    step (``bx_0 += a_0 h``) and the new state is returned."""
    gate = gelu(x @ params["w_in_g"])
    u = x @ params["w_in_x"]
    u, conv_state = _conv1d_causal(
        u, params["conv"], None if state is None else state["conv"])
    r = torch.sigmoid((u @ params["w_a"]).to(torch.float32))
    i = torch.sigmoid((u @ params["w_x"]).to(torch.float32))
    # softplus as jax.nn.softplus computes it, logaddexp(lam, 0) in lam's
    # dtype (F.softplus switches to lam above its threshold of 20; lam
    # lies in [2, 6), where the two agree)
    lam = params["lam"]
    lam = torch.logaddexp(lam, torch.zeros((), dtype=lam.dtype,
                                           device=lam.device))
    log_a = -_C * lam * r
    a = torch.exp(log_a)
    # sqrt(1 - a^2), from log a as the reference computes it
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    bx = mult * i * u.to(torch.float32)
    new_state = None
    if state is not None:
        bx = torch.cat([bx[:, :1] + a[:, :1] * state["h"][:, None], bx[:, 1:]],
                       dim=1)
    h = _scan(a, bx)
    if state is not None:
        new_state = {"h": h[:, -1], "conv": conv_state}
    out = (h.to(x.dtype) * gate) @ params["w_out"]
    return out, new_state
