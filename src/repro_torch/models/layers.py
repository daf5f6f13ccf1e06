"""Dense transformer building blocks on torch tensors.

Parameters are plain dicts of tensors; a projection may instead be a
``kernels.ops.WireMatrix``, whose ``x @ w`` runs the wire-weight matmul.
The attention here covers the two cached branches the serving path runs:

* the contiguous cache ``{"k", "v": [B, Tmax, Hkv, hd], "pos": int}``
  (cached prefill chunks), attended through ``ops.takum_attention``;
* the paged pool ``{"k", "v": [P, ps, Hkv, hd], "table": [B, NP],
  "pos"/"start": [B]}`` (decode steps), through ``ops.paged_attention``.

New K/V are encoded to the cache's wire format and written into the cache
tensors **in place**, one fused append a layer (``ops.kv_append``; the JAX
package returns updated copies; in-place writes keep the serving loop from
copying whole caches every step). Nothing in the paged branch reads a
device value back to the host, so a decode step can be captured in a CUDA
graph (``serve/graphs.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import formats
from repro_torch.core.bitops import carrier
from repro_torch.kernels import ops

__all__ = ["DTYPES", "dense_init", "rmsnorm_init", "rmsnorm", "rope",
           "attn_init", "attention", "mlp_init", "mlp", "embed_init",
           "embed", "unembed", "padded_vocab", "VOCAB_PAD", "put_words"]

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
VOCAB_PAD = 128   # embedding tables padded so the vocab dim tiles evenly


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               scale: Optional[float] = None, dtype=torch.float32,
               device=None) -> torch.Tensor:
    scale = (1.0 / d_in) ** 0.5 if scale is None else scale
    w = torch.randn((d_in, d_out), generator=gen, dtype=dtype, device=device)
    return w.mul_(scale)


def rmsnorm_init(d: int, device=None) -> Dict[str, torch.Tensor]:
    return {"scale": torch.ones(d, dtype=torch.float32, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * params["scale"]
    return out.to(x.dtype)


_FREQS: Dict[Tuple[int, float, str], torch.Tensor] = {}


def _rope_freqs(half: int, base: float, dev) -> torch.Tensor:
    """base^(-i / half), i < half, on ``dev``: computed once per (half,
    base, device) by the same device ops at every call (so the bits stay
    the same), and reused, so that a captured step makes no host copy."""
    key = (half, float(base), str(dev))
    freqs = _FREQS.get(key)
    if freqs is None:
        log_base = torch.log(torch.tensor(base, dtype=torch.float32,
                                          device=dev))
        freqs = torch.exp(-log_base * torch.arange(
            half, dtype=torch.float32, device=dev) / half)
        _FREQS[key] = freqs
    return freqs


def rope(x: torch.Tensor, positions: torch.Tensor,
         base: float = 10_000.0) -> torch.Tensor:
    """x [..., T, H, hd]; positions [..., T]."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = _rope_freqs(half, base, x.device)
    ang = positions[..., :, None].to(torch.float32) * freqs    # [..., T, half]
    ang = ang[..., None, :]                                    # [..., T, 1, half]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def attn_init(gen, d_model, n_heads, n_kv_heads, head_dim,
              dtype=torch.float32, device=None):
    kw = dict(dtype=dtype, device=device)
    return {
        "wq": dense_init(gen, d_model, n_heads * head_dim, **kw),
        "wk": dense_init(gen, d_model, n_kv_heads * head_dim, **kw),
        "wv": dense_init(gen, d_model, n_kv_heads * head_dim, **kw),
        "wo": dense_init(gen, n_heads * head_dim, d_model,
                         scale=(1.0 / (n_heads * head_dim)) ** 0.5, **kw),
    }


def _proj_qkv(params, x, n_heads, n_kv_heads, head_dim, rope_base,
              positions):
    b = x.shape[0]
    q = (x @ params["wq"]).reshape(b, -1, n_heads, head_dim)
    k = (x @ params["wk"]).reshape(b, -1, n_kv_heads, head_dim)
    v = (x @ params["wv"]).reshape(b, -1, n_kv_heads, head_dim)
    return rope(q, positions, rope_base), rope(k, positions, rope_base), v


def put_words(dst: torch.Tensor, index, src: torch.Tensor) -> None:
    """``dst[index] = src`` in place, also for uint16 words (PyTorch's
    CPU ``index_put`` has no uint16: write through an int16 view of the
    same bits)."""
    carrier(dst)[index] = carrier(src)


def attention(params, x: torch.Tensor, cfg, positions: torch.Tensor, *,
              cache: Dict[str, Any], window: int = 0):
    """Self-attention with a decode cache; returns (out, new_cache).

    The cache's K/V tensors are updated in place; ``new_cache`` carries
    the advanced ``pos``."""
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if cache is None:
        raise NotImplementedError("uncached attention is not in the port "
                                  "yet: serving always runs with a cache")
    q, k, v = _proj_qkv(params, x, h, hkv, hd, cfg.rope_base, positions)
    spec = formats.resolve(cfg.kv_quant)
    if "table" in cache:
        # paged decode step: append this step's words at
        # (table[b, pos // ps], pos % ps), then attend through the block
        # table. Idle slots keep stepping with a stale pos: the block
        # index is clamped to the table width (they point at page 0).
        if x.shape[1] != 1:
            raise ValueError(
                "paged KV caches are decode-only (one token per step); "
                "prefill runs on a contiguous cache and is scattered "
                "into pages by the scheduler")
        pos, table = cache["pos"], cache["table"]
        ops.kv_append(k, v, cache["k"], cache["v"], spec, pos=pos,
                      table=table)
        new_cache = dict(cache, pos=pos + 1)
        out = ops.paged_attention(q, cache["k"], cache["v"], table, spec,
                                  pos=pos, start=cache["start"],
                                  window=window).to(x.dtype)
    else:
        # contiguous cache (cached prefill chunk at absolute position pos)
        pos, t = int(cache["pos"]), x.shape[1]
        if pos + t > cache["k"].shape[1]:
            raise ValueError(f"cache of {cache['k'].shape[1]} positions "
                             f"cannot take {t} more at {pos}")
        ops.kv_append(k, v, cache["k"], cache["v"], spec, pos=pos)
        new_cache = dict(cache, pos=pos + t)
        out = ops.takum_attention(q, cache["k"], cache["v"], spec.n, spec,
                                  pos=pos, start=cache.get("start"),
                                  window=window,
                                  block=cfg.kv_block or None).to(x.dtype)
    out = out.reshape(x.shape[0], x.shape[1], h * hd)
    return out @ params["wo"], new_cache


def _check_activation(activation: str) -> None:
    if activation != "swiglu":
        raise NotImplementedError(f"activation {activation!r} is not in the "
                                  "port yet (SwiGLU only)")


def mlp_init(gen, d_model, d_ff, activation, dtype=torch.float32,
             device=None):
    _check_activation(activation)
    kw = dict(dtype=dtype, device=device)
    return {"wg": dense_init(gen, d_model, d_ff, **kw),
            "w1": dense_init(gen, d_model, d_ff, **kw),
            "w2": dense_init(gen, d_ff, d_model, **kw)}


def mlp(params, x: torch.Tensor, activation: str) -> torch.Tensor:
    """SwiGLU: (silu(x @ wg) * (x @ w1)) @ w2."""
    _check_activation(activation)
    hid = F.silu(x @ params["wg"]) * (x @ params["w1"])
    return hid @ params["w2"]


def padded_vocab(vocab: int) -> int:
    return -(-vocab // VOCAB_PAD) * VOCAB_PAD


def embed_init(gen, vocab, d_model, dtype=torch.float32, device=None):
    vp = padded_vocab(vocab)
    return {"embed_tokens": torch.randn((vp, d_model), generator=gen,
                                        dtype=dtype, device=device).mul_(0.02),
            "unembed": dense_init(gen, d_model, vp, dtype=dtype,
                                  device=device)}


def embed(params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return params["embed_tokens"][tokens].to(dtype)


def unembed(params, x: torch.Tensor, vocab: Optional[int] = None):
    logits = (x @ params["unembed"]).to(torch.float32)
    if vocab is not None and logits.shape[-1] != vocab:
        logits = logits[..., :vocab]     # drop the vocab padding
    return logits

