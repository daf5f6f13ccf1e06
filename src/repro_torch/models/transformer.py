"""Decoder-only model of the dense, moe, hybrid RG-LRU, rwkv6 and vlm
families: parameters, caches, cached forward.

Parameters are a plain dict::

    {"embed_tokens": [Vp, d], "unembed": [d, Vp], "final_norm": {"scale"},
     "layers": [{"ln1", "ln2", "attn": {wq, wk, wv, wo},
                 "mlp": {wg, w1, w2}}, ...]}

one entry of ``layers`` per layer, in layer order (the JAX package stacks
the layers of each scan group on a leading axis and runs ``lax.scan``;
here a Python loop walks the list). A moe layer holds ``"moe": {router,
experts_wg, experts_w1, experts_w2}`` (``models/moe.py``) in place of
``"mlp"``; a relu2 or gelu MLP has no ``wg``; a recurrent (``rec``) layer
holds ``"rec"`` (``models/rglru.py``) in place of ``"attn"``; an rwkv6
layer holds ``{"ln1", "ln2", "blk": {"tm", "cm"}}`` (``models/rwkv6.py``);
a vlm ``cross`` layer is an attention block whose K/V come from the
media (and a vlm model whose ``d_media`` differs from ``d_model`` has an
``"embed_media" [d_media, d]`` projection); a model with tied
embeddings has no ``"unembed"``. :func:`layer_plan` is the reference's
plan of scan groups, and :func:`layer_kinds` the block kind of each
layer in order. The encdec family is ``models/encdec.py``.
``forward`` runs without a cache, ``forward_cached`` with one.
Caches are lists with one dict per layer: the attention cache in the
layout ``layers.attention`` takes, ``{"rec": {"h", "conv"}}``,
``{"tm": {"S", "tm_prev"}, "cm": {"cm_prev"}}`` (rwkv6), or ``{}`` (a
cross layer: its K/V are recomputed from the media at every call, as in
the reference).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import formats
from repro_torch.configs.base import ModelConfig
from repro_torch.core.bitops import zeros_words
from repro_torch.device import check_generator, resolve_device
from repro_torch.kernels.ops import WireMatrix
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rg
from repro_torch.models import rwkv6 as rk

__all__ = ["cast_params", "init", "init_layer", "init_cache",
           "init_paged_cache", "forward", "forward_cached",
           "paged_supported", "layer_plan", "layer_kinds", "layer_index",
           "FAMILIES"]

FAMILIES = ("dense", "moe", "hybrid_rglru", "rwkv6", "vlm", "encdec")


def layer_plan(cfg: ModelConfig) -> List[Tuple[Tuple[str, ...], int]]:
    """The reference's scan groups: ``(kinds of a super-block, repeats)``.
    The hybrid family repeats its block pattern (``attn`` read as
    ``self``) and ends with the pattern's head as a remainder group; the
    vlm family repeats a ``cross`` block and ``cross_attn_every - 1``
    ``self`` blocks."""
    if cfg.family == "rwkv6":
        return [(("rwkv",), cfg.n_layers)]
    if cfg.family == "hybrid_rglru":
        pat = cfg.block_pattern or ("rec", "rec", "attn")
        pat = tuple("self" if k == "attn" else k for k in pat)
        plan = [(pat, cfg.n_layers // len(pat))]
        rem = cfg.n_layers % len(pat)
        if rem:
            plan.append((pat[:rem], 1))
        return plan
    if cfg.family == "vlm" and cfg.cross_attn_every:
        k = cfg.cross_attn_every
        if cfg.n_layers % k:
            raise ValueError(f"vlm: n_layers {cfg.n_layers} is not a "
                             f"multiple of cross_attn_every {k}")
        return [(("cross",) + ("self",) * (k - 1), cfg.n_layers // k)]
    return [(("moe" if cfg.family == "moe" else "self",), cfg.n_layers)]


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """The block kind of every layer, in layer order (group by group,
    repeat by repeat)."""
    return [kind for pat, n_rep in layer_plan(cfg) for _ in range(n_rep)
            for kind in pat]


def layer_index(cfg: ModelConfig) -> List[Tuple[int, int, int]]:
    """``(group, block, repeat)`` of every layer, in layer order: the
    reference's group g repeats its super-block, so layer ``offset_g +
    r * len(pattern) + i`` is repeat r of block ``b{i}``, a slice of the
    reference's stacked leaf ``groups[g]["b{i}"]``."""
    return [(g, i, r) for g, (pat, n_rep) in enumerate(layer_plan(cfg))
            for r in range(n_rep) for i in range(len(pat))]


def _window_for(cfg: ModelConfig, kind: str) -> int:
    if cfg.family == "hybrid_rglru" and kind == "self":
        return cfg.window
    return 0


def paged_supported(cfg: ModelConfig) -> bool:
    """Whether ``cfg``'s layers can run on the paged KV cache, as the
    reference's: every block an attention block (``self``/``moe``).
    Recurrent families carry O(1) state a sequence, with nothing to page,
    and cross-attention and encdec layers hold media or encoder state
    outside the pool's layout."""
    if cfg.family == "encdec":
        return False
    return all(kind in ("self", "moe")
               for pat, _ in layer_plan(cfg) for kind in pat)


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not in the port "
                                  f"({', '.join(FAMILIES)} only)")
    if cfg.family == "encdec":
        raise ValueError("the encdec family is models/encdec.py (through "
                         "models/model.py), not the decoder-only stack")


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


def init_layer(gen: torch.Generator, cfg: ModelConfig, *, kind=None,
               device=None, dtype=None) -> Dict[str, Any]:
    """One block's float parameters, drawn from ``gen`` with the
    reference's scales (normal * d_in^-1/2; ``wo`` by (H * hd)^-1/2), on
    ``device`` (``cuda`` unless given; ``gen`` must draw there). ``kind``
    is the block's (:func:`layer_kinds`; default the family's first)."""
    device = resolve_device(device)
    check_generator(gen, device)
    dtype = L.DTYPES[cfg.param_dtype] if dtype is None else dtype
    kind = layer_kinds(cfg)[0] if kind is None else kind
    d = cfg.d_model
    p = {"ln1": L.rmsnorm_init(d, device), "ln2": L.rmsnorm_init(d, device)}
    if kind == "rwkv":
        p["blk"] = rk.rwkv_block_init(gen, d, cfg.d_ff, cfg.rwkv_head_dim,
                                      dtype, device)
        return p
    if kind == "rec":
        p["rec"] = rg.rglru_block_init(gen, d, cfg.lru_width or d, dtype,
                                       device)
    else:
        p["attn"] = L.attn_init(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                dtype, device)
    if kind == "moe":
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
    params = L.embed_init(gen, cfg.vocab, cfg.d_model, cfg.tie_embeddings,
                          dtype, device)
    params["final_norm"] = L.rmsnorm_init(cfg.d_model, device)
    if cfg.family == "vlm" and cfg.d_media and cfg.d_media != cfg.d_model:
        params["embed_media"] = L.dense_init(gen, cfg.d_media, cfg.d_model,
                                             dtype=dtype, device=device)
    params["layers"] = [init_layer(gen, cfg, kind=kind, device=device,
                                   dtype=dtype)
                        for kind in layer_kinds(cfg)]
    return params


def _kv_dtype(cfg: ModelConfig, dtype):
    spec = formats.resolve(cfg.kv_quant)
    return spec.word_dtype or (L.DTYPES[cfg.dtype] if dtype is None else dtype)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device=None,
               dtype=None, start=None) -> List[Dict[str, Any]]:
    """Contiguous cache: per attention layer ``{"k", "v": [B, max_len,
    Hkv, hd], "pos": 0}`` (wire words, or ``dtype`` floats for the
    identity codec), plus ``start [B]`` when given (left-padded prompts);
    per recurrent layer ``{"rec": {"h", "conv"}}`` or rwkv6's ``{"tm":
    {"S", "tm_prev"}, "cm": {"cm_prev"}}`` (zeros); per cross layer
    ``{}``. On ``device`` (``cuda`` unless given)."""
    _check_family(cfg)
    device = resolve_device(device)
    kv = _kv_dtype(cfg, dtype)
    act = L.DTYPES[cfg.dtype] if dtype is None else dtype
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    caches = []
    for kind in layer_kinds(cfg):
        if kind == "rec":
            caches.append({"rec": rg.rglru_decode_state(
                batch, cfg.lru_width or cfg.d_model, act, device)})
            continue
        if kind == "rwkv":
            st = rk.rwkv_decode_state(batch, cfg.d_model, cfg.rwkv_head_dim,
                                      act, device)
            caches.append({"tm": {"S": st["S"], "tm_prev": st["tm_prev"]},
                           "cm": {"cm_prev": st["cm_prev"]}})
            continue
        if kind == "cross":
            caches.append({})
            continue
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
    if not paged_supported(cfg):
        raise ValueError(f"a paged KV cache needs an attention-only layer "
                         f"plan; family {cfg.family!r} has non-attention "
                         "state (use the contiguous init_cache)")
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
           prefill_fresh=False, kind="self", media=None):
    """One pre-norm block of ``kind``: (x, aux, new cache or None);
    ``aux`` is the moe block's load-balance term, None otherwise (no op
    added to a dense step). A ``cross`` block attends ``media`` without a
    mask (with ``media`` None: the block's own input, as the
    reference's), and leaves its cache as it is."""
    if kind == "rwkv":
        h, st = rk.rwkv_time_mix(p["blk"], L.rmsnorm(p["ln1"], x),
                                 cfg.rwkv_head_dim,
                                 state=None if cache is None else cache["tm"])
        x = x + h
        h, st2 = rk.rwkv_channel_mix(p["blk"], L.rmsnorm(p["ln2"], x),
                                     state=None if cache is None
                                     else cache["cm"])
        return x + h, None, (None if cache is None
                             else {"tm": st, "cm": st2})
    if kind == "cross":
        h, _ = L.attention(p["attn"], L.rmsnorm(p["ln1"], x), cfg, positions,
                           xa=media)
        x = x + h
        return x + L.mlp(p["mlp"], L.rmsnorm(p["ln2"], x), cfg.activation), \
            None, cache
    if kind == "rec":
        h, st = rg.rglru_block_apply(p["rec"], L.rmsnorm(p["ln1"], x),
                                     state=None if cache is None
                                     else cache["rec"])
        cache = None if cache is None else {"rec": st}
    else:
        h, cache = L.attention(p["attn"], L.rmsnorm(p["ln1"], x), cfg,
                               positions, cache=cache, mask=mask,
                               window=_window_for(cfg, kind),
                               prefill_fresh=prefill_fresh)
    x = x + h
    aux = None
    if kind == "moe":
        h, aux = moe_mod.moe_apply(p["moe"], L.rmsnorm(p["ln2"], x),
                                   n_experts=cfg.n_experts, top_k=cfg.top_k,
                                   capacity_factor=cfg.capacity_factor)
    else:
        # the attention cache dict goes through the MLP's TP seam, so its
        # error-feedback residual (tp_res_m) lives beside the pages
        h, cache = L.mlp_tp(p["mlp"], L.rmsnorm(p["ln2"], x),
                            cfg.activation, cache)
    return x + h, aux, cache


def _layers(params, x, cfg, positions, caches, *, mask=None, media=None,
            prefill_fresh=False, remat=False):
    """Every block in order; returns (x, the moe blocks' summed aux or
    None, new caches or None).
    ``remat`` (uncached only) keeps each block's input and recomputes the
    rest of it in the backward, the counterpart of the reference's
    ``jax.checkpoint(..., nothing_saveable)`` per scanned block."""
    new_caches = []
    aux = None
    for i, (p, kind) in enumerate(zip(params["layers"], layer_kinds(cfg),
                                      strict=True)):
        if remat and caches is None:
            x, aux_i, _ = checkpoint(_block, p, x, cfg, positions, None,
                                     mask, False, kind, media,
                                     use_reentrant=False)
        else:
            cache = None if caches is None else caches[i]
            x, aux_i, cache = _block(p, x, cfg, positions, cache, mask,
                                     prefill_fresh, kind, media)
            new_caches.append(cache)
        if aux_i is not None:
            aux = aux_i if aux is None else aux + aux_i
    return x, aux, (new_caches if caches is not None else None)


def _prep_media(params, media: Optional[torch.Tensor], dtype):
    """The media the cross blocks attend: cast to ``dtype``, through
    ``embed_media`` where the model has one; None stays None."""
    if media is None:
        return None
    media = media.to(dtype)
    if "embed_media" in params:
        media = media @ params["embed_media"]
    return media


def _pad_for_rwkv(cfg: ModelConfig, tokens: torch.Tensor):
    """rwkv6: tokens right-padded with 0 to a multiple of ``CHUNK`` (the
    chunked WKV's length); (tokens, the length before)."""
    t = tokens.shape[1]
    pad = -t % rk.CHUNK if cfg.family == "rwkv6" else 0
    if pad:
        tokens = torch.nn.functional.pad(tokens, (0, pad))
    return tokens, t


def forward(params, tokens: torch.Tensor, cfg: ModelConfig, *,
            media: Optional[torch.Tensor] = None, remat: bool = False,
            features: bool = False):
    """Uncached forward: tokens [B, T] -> (logits [B, T, V] f32, aux).
    ``aux`` is the reference's auxiliary loss: the moe blocks' summed
    load-balance terms, 0 for the other families.
    Below ``ATTN_CHUNK_T`` tokens attention runs under a causal mask;
    from there on the chunked attention builds its own bands. rwkv6 pads
    T to a multiple of its chunk and drops the padding's outputs; vlm's
    cross blocks attend ``media [B, M, d_media]``. ``remat`` recomputes
    each block in the backward; ``features`` returns the final-norm
    hidden states [B, T, d] instead of logits (the chunked cross entropy
    unembeds them a chunk at a time)."""
    _check_family(cfg)
    dtype = L.DTYPES[cfg.dtype]
    params = cast_params(params, dtype)
    tokens, t_orig = _pad_for_rwkv(cfg, tokens)
    b, t = tokens.shape
    x = L.embed(params, tokens, dtype)
    positions = torch.arange(t, device=tokens.device).expand(b, t)
    mask = (L.causal_mask(t, t, window=_window_for(cfg, "self"),
                          device=tokens.device)
            if cfg.family != "rwkv6" and t < L.ATTN_CHUNK_T else None)
    x, aux, _ = _layers(params, x, cfg, positions, None, mask=mask,
                        media=_prep_media(params, media, dtype),
                        remat=remat)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = L.rmsnorm(params["final_norm"], x)[:, :t_orig]
    if features:
        return x, aux
    return L.unembed(params, x, vocab=cfg.vocab), aux


def forward_cached(params, tokens: torch.Tensor, cfg: ModelConfig, caches,
                   *, pos, media: Optional[torch.Tensor] = None,
                   last_only: bool = False):
    """Prefill (T > 1, contiguous cache) or decode step (T == 1) with
    state. ``pos`` is the position of ``tokens[:, 0]`` (an int, or a
    ``[B, 1]`` tensor of per-row positions for a packed decode step). A
    ``T > 1`` call may take the fresh-prefill attention (``pos`` 0, no
    ``start``, ``T`` from ``ATTN_CHUNK_T`` on, as in the reference); an
    rwkv6 prefill must be a multiple of its chunk (the carried state
    takes no padding). vlm's cross blocks attend ``media`` (None: their
    own input). ``last_only`` unembeds the last position only. Returns
    (logits [B, T_eff, V] f32, new caches)."""
    _check_family(cfg)
    dtype = L.DTYPES[cfg.dtype]
    params = cast_params(params, dtype)
    b, t = tokens.shape
    if cfg.family == "rwkv6" and t > 1 and t % rk.CHUNK:
        raise ValueError(f"rwkv6 prefill length must be a multiple of "
                         f"{rk.CHUNK}, got {t}")
    x = L.embed(params, tokens, dtype)
    ar = torch.arange(t, device=tokens.device)
    positions = (torch.as_tensor(pos, device=tokens.device) + ar).expand(b, t)
    x, _, new_caches = _layers(params, x, cfg, positions, caches,
                               media=_prep_media(params, media, dtype),
                               prefill_fresh=t > 1)
    x = L.rmsnorm(params["final_norm"], x)
    if last_only:
        x = x[:, t - 1:t]
    return L.unembed(params, x, vocab=cfg.vocab), new_caches
