"""Decoder-only transformer of the dense and moe families: parameters,
caches, cached forward.

Parameters are a plain dict::

    {"embed_tokens": [Vp, d], "unembed": [d, Vp], "final_norm": {"scale"},
     "layers": [{"ln1", "ln2", "attn": {wq, wk, wv, wo},
                 "mlp": {wg, w1, w2}}, ...]}

one entry of ``layers`` per layer (the JAX package stacks them on a
leading axis and runs ``lax.scan``; here a Python loop walks the list).
A moe layer holds ``"moe": {router, experts_wg, experts_w1, experts_w2}``
(``models/moe.py``) in place of ``"mlp"``.
``forward`` runs without a cache, ``forward_cached`` with one.
Caches are lists with one dict per layer, in the layout ``layers.attention``
takes.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import formats
from repro_torch.configs.base import ModelConfig
from repro_torch.core.bitops import zeros_words
from repro_torch.device import check_generator, resolve_device
from repro_torch.kernels.ops import WireMatrix
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod

__all__ = ["cast_params", "init", "init_layer", "init_cache",
           "init_paged_cache", "forward", "forward_cached",
           "paged_supported", "FAMILIES"]

FAMILIES = ("dense", "moe")


def paged_supported(cfg: ModelConfig) -> bool:
    """Whether ``cfg``'s layers are all attention blocks (the reference's
    ``self``/``moe`` kinds), the families this package serves and pages:
    dense and moe."""
    return cfg.family in FAMILIES


def _check_family(cfg: ModelConfig) -> None:
    if not paged_supported(cfg):
        raise NotImplementedError(f"family {cfg.family!r} is not in the port "
                                  f"yet ({' and '.join(FAMILIES)} only)")


def cast_params(params, dtype):
    """Compute-dtype view of the parameters: float leaves cast to
    ``dtype`` (no copy when already there); ``WireMatrix`` leaves pass
    through, so every ``x @ w`` keeps its words."""
    if isinstance(params, WireMatrix):
        return params
    if isinstance(params, dict):
        return {k: cast_params(v, dtype) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(cast_params(v, dtype) for v in params)
    if isinstance(params, torch.Tensor) and params.is_floating_point():
        return params.to(dtype)
    return params


def init_layer(gen: torch.Generator, cfg: ModelConfig, *, device=None,
               dtype=None) -> Dict[str, Any]:
    """One block's float parameters, drawn from ``gen`` with the
    reference's scales (normal * d_in^-1/2; ``wo`` by (H * hd)^-1/2),
    on ``device`` (``cuda`` unless given; ``gen`` must draw there)."""
    device = resolve_device(device)
    check_generator(gen, device)
    dtype = L.DTYPES[cfg.param_dtype] if dtype is None else dtype
    d = cfg.d_model
    p = {"ln1": L.rmsnorm_init(d, device), "ln2": L.rmsnorm_init(d, device),
         "attn": L.attn_init(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                             dtype, device)}
    if cfg.family == "moe":
        p["moe"] = moe_mod.moe_init(gen, d, cfg.d_ff, cfg.n_experts,
                                    dtype, device)
    else:
        p["mlp"] = L.mlp_init(gen, d, cfg.d_ff, cfg.activation, dtype,
                              device)
    return p


def init(gen: torch.Generator, cfg: ModelConfig, *, device=None,
         dtype=None) -> Dict[str, Any]:
    """Random parameters (the reference's scales, torch's generator:
    the draws differ from ``jax.random``; tests carry the reference's
    weights over with ``convert.params_from_numpy`` instead), on
    ``device`` (``cuda`` unless given; ``gen`` must draw there)."""
    _check_family(cfg)
    device = resolve_device(device)
    check_generator(gen, device)
    dtype = L.DTYPES[cfg.param_dtype] if dtype is None else dtype
    params = L.embed_init(gen, cfg.vocab, cfg.d_model, dtype, device)
    params["final_norm"] = L.rmsnorm_init(cfg.d_model, device)
    params["layers"] = [init_layer(gen, cfg, device=device, dtype=dtype)
                        for _ in range(cfg.n_layers)]
    return params


def _kv_dtype(cfg: ModelConfig, dtype):
    spec = formats.resolve(cfg.kv_quant)
    return spec.word_dtype or (L.DTYPES[cfg.dtype] if dtype is None else dtype)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device=None,
               dtype=None, start=None) -> List[Dict[str, Any]]:
    """Contiguous cache: per layer ``{"k", "v": [B, max_len, Hkv, hd],
    "pos": 0}`` (wire words, or ``dtype`` floats for the identity codec),
    plus ``start [B]`` when given (left-padded prompts), on ``device``
    (``cuda`` unless given)."""
    _check_family(cfg)
    device = resolve_device(device)
    kv = _kv_dtype(cfg, dtype)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    caches = []
    for _ in range(cfg.n_layers):
        c = {"k": zeros_words(shape, kv, device),
             "v": zeros_words(shape, kv, device), "pos": 0}
        if start is not None:
            c["start"] = torch.as_tensor(start, dtype=torch.int32,
                                         device=device)
        caches.append(c)
    return caches


def init_paged_cache(cfg: ModelConfig, batch: int, num_pages: int,
                     page_size: int, max_pages: int, *, device=None,
                     dtype=None) -> List[Dict[str, Any]]:
    """Paged cache: per layer a ``[num_pages, page_size, Hkv, hd]`` K and
    V pool; ``table [batch, max_pages]``, ``pos``/``start [batch]`` are
    shared by every layer (the serving layer installs them; page 0 is
    the scratch page idle slots point at). On ``device`` (``cuda``
    unless given)."""
    _check_family(cfg)
    device = resolve_device(device)
    kv = _kv_dtype(cfg, dtype)
    shape = (num_pages, page_size, cfg.n_kv_heads, cfg.hd)
    table = torch.zeros((batch, max_pages), dtype=torch.int32, device=device)
    pos = torch.zeros(batch, dtype=torch.int32, device=device)
    start = torch.zeros(batch, dtype=torch.int32, device=device)
    return [{"k": zeros_words(shape, kv, device),
             "v": zeros_words(shape, kv, device),
             "table": table, "pos": pos, "start": start}
            for _ in range(cfg.n_layers)]


def _block(p, x, cfg, positions, cache=None, mask=None,
           prefill_fresh=False):
    """One pre-norm block: (x, aux, new cache or None); ``aux`` is the
    moe block's load-balance term, None for a dense block (no op added
    to a dense step)."""
    h, cache = L.attention(p["attn"], L.rmsnorm(p["ln1"], x), cfg,
                           positions, cache=cache, mask=mask,
                           prefill_fresh=prefill_fresh)
    x = x + h
    if "moe" in p:
        h, aux = moe_mod.moe_apply(p["moe"], L.rmsnorm(p["ln2"], x),
                                   n_experts=cfg.n_experts, top_k=cfg.top_k,
                                   capacity_factor=cfg.capacity_factor)
    else:
        h = L.mlp(p["mlp"], L.rmsnorm(p["ln2"], x), cfg.activation)
        aux = None
    return x + h, aux, cache


def _layers(params, x, cfg, positions, caches, *, mask=None,
            prefill_fresh=False, remat=False):
    """Every block in order; returns (x, the moe blocks' summed aux or
    None, new caches or None).
    ``remat`` (uncached only) keeps each block's input and recomputes the
    rest of it in the backward, the counterpart of the reference's
    ``jax.checkpoint(..., nothing_saveable)`` per scanned block."""
    new_caches = []
    aux = None
    for i, p in enumerate(params["layers"]):
        if remat and caches is None:
            x, aux_i, _ = checkpoint(_block, p, x, cfg, positions, None,
                                     mask, use_reentrant=False)
        else:
            cache = None if caches is None else caches[i]
            x, aux_i, cache = _block(p, x, cfg, positions, cache, mask,
                                     prefill_fresh)
            new_caches.append(cache)
        if aux_i is not None:
            aux = aux_i if aux is None else aux + aux_i
    return x, aux, (new_caches if caches is not None else None)


def forward(params, tokens: torch.Tensor, cfg: ModelConfig, *,
            remat: bool = False, features: bool = False):
    """Uncached forward: tokens [B, T] -> (logits [B, T, V] f32, aux).
    ``aux`` is the reference's auxiliary loss: the moe blocks' summed
    load-balance terms, 0 for the dense family.
    Below ``ATTN_CHUNK_T`` tokens attention runs under a causal mask;
    from there on the chunked attention builds its own bands. ``remat``
    recomputes each block in the backward; ``features`` returns the
    final-norm hidden states [B, T, d] instead of logits (the chunked
    cross entropy unembeds them a chunk at a time)."""
    _check_family(cfg)
    dtype = L.DTYPES[cfg.dtype]
    params = cast_params(params, dtype)
    b, t = tokens.shape
    x = L.embed(params, tokens, dtype)
    positions = torch.arange(t, device=tokens.device).expand(b, t)
    mask = (L.causal_mask(t, t, device=tokens.device)
            if t < L.ATTN_CHUNK_T else None)
    x, aux, _ = _layers(params, x, cfg, positions, None, mask=mask,
                        remat=remat)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = L.rmsnorm(params["final_norm"], x)
    if features:
        return x, aux
    return L.unembed(params, x, vocab=cfg.vocab), aux


def forward_cached(params, tokens: torch.Tensor, cfg: ModelConfig, caches,
                   *, pos, last_only: bool = False):
    """Prefill (T > 1, contiguous cache) or decode step (T == 1) with
    state. ``pos`` is the position of ``tokens[:, 0]`` (an int, or a
    ``[B, 1]`` tensor of per-row positions for a packed decode step). A
    ``T > 1`` call may take the fresh-prefill attention (``pos`` 0, no
    ``start``, ``T`` from ``ATTN_CHUNK_T`` on, as in the reference).
    ``last_only`` unembeds the last position only. Returns (logits
    [B, T_eff, V] f32, new caches)."""
    _check_family(cfg)
    dtype = L.DTYPES[cfg.dtype]
    params = cast_params(params, dtype)
    b, t = tokens.shape
    x = L.embed(params, tokens, dtype)
    ar = torch.arange(t, device=tokens.device)
    positions = (torch.as_tensor(pos, device=tokens.device) + ar).expand(b, t)
    x, _, new_caches = _layers(params, x, cfg, positions, caches,
                               prefill_fresh=t > 1)
    x = L.rmsnorm(params["final_norm"], x)
    if last_only:
        x = x[:, t - 1:t]
    return L.unembed(params, x, vocab=cfg.vocab), new_caches
