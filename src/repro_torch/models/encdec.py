"""Encoder-decoder model (the seamless-m4t family) on torch tensors.

Encoder: a bidirectional self-attention transformer over precomputed
frontend embeddings (the audio frontend is a stub: the caller supplies
frame embeddings ``[B, T_a, d]``). Decoder: causal self-attention, then
cross-attention to the encoder output, then the MLP. Parameters::

    {"embed_tokens", "unembed", "final_norm", "enc_norm",
     "enc": [{"ln1", "ln2", "attn", "mlp"}, ...],
     "dec": [{"ln1", "ln_x", "ln2", "attn", "xattn", "mlp"}, ...]}

one dict a layer, in layer order (the reference stacks each of ``enc``
and ``dec`` on a leading axis and scans it). The serving cache is the
decoder's self-attention cache, one contiguous ``{"k", "v", "pos"}`` a
layer in the compute dtype: the reference's ``init_cache`` allocates it
so and ignores ``kv_quant``, and its prefill fails on wire words, so a
wire ``kv_quant`` is refused here by name, before any launch. Like the
reference's, the cache takes no ``start``: left-padded decoder prompts
attend their pads. Cross-attention keeps no cache: its K/V are computed
from the encoder output at every call.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import formats
from repro_torch.configs.base import ModelConfig
from repro_torch.core.bitops import zeros_words
from repro_torch.device import check_generator, resolve_device
from repro_torch.models import layers as L
from repro_torch.models.transformer import cast_params

__all__ = ["init", "encode", "decode", "forward", "init_cache"]


def _enc_block_init(gen, cfg: ModelConfig, dtype, device):
    d = cfg.d_model
    return {"ln1": L.rmsnorm_init(d, device), "ln2": L.rmsnorm_init(d, device),
            "attn": L.attn_init(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                dtype, device),
            "mlp": L.mlp_init(gen, d, cfg.d_ff, cfg.activation, dtype,
                              device)}


def _dec_block_init(gen, cfg: ModelConfig, dtype, device):
    d = cfg.d_model
    return {"ln1": L.rmsnorm_init(d, device),
            "ln_x": L.rmsnorm_init(d, device),
            "ln2": L.rmsnorm_init(d, device),
            "attn": L.attn_init(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                dtype, device),
            "xattn": L.attn_init(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                 dtype, device),
            "mlp": L.mlp_init(gen, d, cfg.d_ff, cfg.activation, dtype,
                              device)}


def init(gen: torch.Generator, cfg: ModelConfig, *, device=None,
         dtype=None) -> Dict[str, Any]:
    """Random parameters with the reference's scales (torch's draws), on
    ``device`` (``cuda`` unless given; ``gen`` must draw there)."""
    device = resolve_device(device)
    check_generator(gen, device)
    dtype = L.DTYPES[cfg.param_dtype] if dtype is None else dtype
    params = L.embed_init(gen, cfg.vocab, cfg.d_model, cfg.tie_embeddings,
                          dtype, device)
    params["final_norm"] = L.rmsnorm_init(cfg.d_model, device)
    params["enc_norm"] = L.rmsnorm_init(cfg.d_model, device)
    params["enc"] = [_enc_block_init(gen, cfg, dtype, device)
                     for _ in range(cfg.n_enc_layers)]
    params["dec"] = [_dec_block_init(gen, cfg, dtype, device)
                     for _ in range(cfg.n_layers)]
    return params


def _enc_block(p, x, cfg, positions):
    h, _ = L.attention(p["attn"], L.rmsnorm(p["ln1"], x), cfg, positions,
                       bidirectional=True)
    x = x + h
    return x + L.mlp(p["mlp"], L.rmsnorm(p["ln2"], x), cfg.activation)


def encode(params, media: torch.Tensor, cfg: ModelConfig, *,
           remat: bool = False) -> torch.Tensor:
    """media [B, T_a, d] (the frontend stub's output) -> the encoder's
    states [B, T_a, d]: bidirectional attention (unmasked ``_sdpa``, or
    the chunked attention from ``ATTN_CHUNK_T`` frames)."""
    if media is None:
        raise ValueError("encdec: encode needs the frontend's media "
                         "[B, T_a, d_model]")
    dtype = L.DTYPES[cfg.dtype]
    params = cast_params(params, dtype)
    x = media.to(dtype)
    b, ta, _ = x.shape
    positions = torch.arange(ta, device=x.device).expand(b, ta)
    for p in params["enc"]:
        if remat:
            x = checkpoint(_enc_block, p, x, cfg, positions,
                           use_reentrant=False)
        else:
            x = _enc_block(p, x, cfg, positions)
    return L.rmsnorm(params["enc_norm"], x)


def _dec_block(p, x, enc_out, cfg, positions, mask, cache, prefill_fresh):
    h, newc = L.attention(p["attn"], L.rmsnorm(p["ln1"], x), cfg, positions,
                          mask=mask, cache=cache, prefill_fresh=prefill_fresh)
    x = x + h
    h, _ = L.attention(p["xattn"], L.rmsnorm(p["ln_x"], x), cfg, positions,
                       xa=enc_out)
    x = x + h
    return x + L.mlp(p["mlp"], L.rmsnorm(p["ln2"], x), cfg.activation), newc


def decode(params, tokens: torch.Tensor, enc_out: torch.Tensor,
           cfg: ModelConfig, *, caches: Optional[List[Dict]] = None, pos=0,
           remat: bool = False, features: bool = False):
    """The decoder over ``tokens [B, T]`` at positions ``pos + t``:
    uncached under a causal mask (training), or with the self-attention
    ``caches`` (serving: a prefill from ``pos`` 0, or a decode step).
    Returns (logits [B, T, V] f32, or the final-norm features with
    ``features``; the new caches or None)."""
    dtype = L.DTYPES[cfg.dtype]
    params = cast_params(params, dtype)
    b, t = tokens.shape
    x = L.embed(params, tokens, dtype)
    ar = torch.arange(t, device=tokens.device)
    positions = (torch.as_tensor(pos, device=tokens.device) + ar).expand(b, t)
    mask = (L.causal_mask(t, t, device=tokens.device)
            if caches is None else None)
    enc_out = enc_out.to(dtype)
    prefill_fresh = caches is not None and t > 1
    new_caches = []
    for i, p in enumerate(params["dec"]):
        if remat and caches is None:
            x, _ = checkpoint(_dec_block, p, x, enc_out, cfg, positions, mask,
                              None, False, use_reentrant=False)
            continue
        x, newc = _dec_block(p, x, enc_out, cfg, positions, mask,
                             None if caches is None else caches[i],
                             prefill_fresh)
        new_caches.append(newc)
    x = L.rmsnorm(params["final_norm"], x)
    new_caches = None if caches is None else new_caches
    if features:
        return x, new_caches
    return L.unembed(params, x, vocab=cfg.vocab), new_caches


def forward(params, tokens: torch.Tensor, cfg: ModelConfig, *,
            media: Optional[torch.Tensor] = None, remat: bool = False,
            features: bool = False):
    """The whole model uncached: (logits [B, T, V] or features, aux = 0)."""
    dtype = L.DTYPES[cfg.dtype]
    params = cast_params(params, dtype)
    enc_out = encode(params, media, cfg, remat=remat)
    out, _ = decode(params, tokens, enc_out, cfg, remat=remat,
                    features=features)
    return out, torch.zeros((), dtype=torch.float32, device=out.device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device=None,
               dtype=None) -> List[Dict[str, Any]]:
    """The decoder's self-attention caches: per layer ``{"k", "v": [B,
    max_len, Hkv, hd], "pos": 0}`` in ``dtype`` (the compute dtype unless
    given), on ``device`` (``cuda`` unless given). A wire ``kv_quant`` is
    refused (see the module's docstring)."""
    spec = formats.resolve(cfg.kv_quant)
    if not spec.is_identity:
        raise ValueError(f"encdec serves with a float KV cache only: "
                         f"kv_quant {cfg.kv_quant!r} is a wire format (the "
                         "reference's encdec cache holds the compute dtype "
                         "and its prefill fails on wire words)")
    device = resolve_device(device)
    dtype = L.DTYPES[cfg.dtype] if dtype is None else dtype
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return [{"k": zeros_words(shape, dtype, device),
             "v": zeros_words(shape, dtype, device), "pos": 0}
            for _ in range(cfg.n_layers)]
