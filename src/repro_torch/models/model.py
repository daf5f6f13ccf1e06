"""Model API used by the serving layer, dispatching on the config's
family (``models/encdec.py`` for encdec, ``models/transformer.py`` for
the others)::

    init(gen, cfg)                                  -> params
    init_cache(cfg, batch, max_len)                 -> contiguous cache
    init_paged_cache(cfg, batch, num_pages, ...)    -> paged cache
    forward(params, {"tokens", "media"?}, cfg, remat)
                                                    -> (logits [B, T, V], aux)
    loss_fn(params, batch, cfg, remat)              -> (loss, metrics)
    prefill(params, tokens, cfg, cache, media=None) -> (logits [B, V], cache)
    prefill_chunk(params, tokens, cfg, cache, pos, last_idx)
                                                    -> (logits [B, V], cache)
    decode_step(params, tokens, cfg, cache, pos, media=None)
                                                    -> (logits [B, V], cache)

``media`` is the frontend stub's output: vlm's patch embeddings
``[B, M, d_media]``, attended by its cross blocks, or encdec's frame
embeddings ``[B, T_a, d]``, which the encoder reads. ``init`` and the
caches go to ``cuda`` unless the caller passes ``device="cpu"``; without
a card they raise.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import encdec, transformer

__all__ = ["init", "init_cache", "init_paged_cache", "forward", "loss_fn",
           "prefill", "prefill_chunk", "decode_step", "AUX_WEIGHT",
           "CHUNK_XENT_T", "XENT_CHUNK"]

AUX_WEIGHT = 0.01
CHUNK_XENT_T = 2048   # chunk the unembed + xent at and above this length
XENT_CHUNK = 1024


def _mod(cfg: ModelConfig):
    return encdec if cfg.family == "encdec" else transformer


def init(gen: torch.Generator, cfg: ModelConfig, *, device=None):
    return _mod(cfg).init(gen, cfg, device=device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device=None,
               dtype=None, enc_len: Optional[int] = None, start=None):
    """The contiguous cache. encdec's is ``{"dec": the decoder's caches,
    "enc_out": zeros [B, enc_len, d]}`` (``enc_len`` defaults to
    ``max(max_len // 4, 8)``; prefill replaces it by the encoder's
    output) and takes no ``start``, as the reference's."""
    if cfg.family == "encdec":
        dev = resolve_device(device)
        d = L.DTYPES[cfg.dtype] if dtype is None else dtype
        enc_len = enc_len or max(max_len // 4, 8)
        return {"dec": encdec.init_cache(cfg, batch, max_len, device=dev,
                                         dtype=dtype),
                "enc_out": torch.zeros((batch, enc_len, cfg.d_model),
                                       dtype=d, device=dev)}
    return transformer.init_cache(cfg, batch, max_len, device=device,
                                  dtype=dtype, start=start)


def init_paged_cache(cfg: ModelConfig, batch: int, num_pages: int,
                     page_size: int, max_pages: int, *, device=None,
                     dtype=None):
    return transformer.init_paged_cache(cfg, batch, num_pages, page_size,
                                        max_pages, device=device, dtype=dtype)


def forward(params, batch, cfg: ModelConfig, *, remat: bool = False):
    """Uncached forward over ``batch["tokens"]`` [B, T] (and
    ``batch["media"]``, if any): (logits [B, T, V], aux), as the
    reference's ``model.forward``."""
    return _mod(cfg).forward(params, batch["tokens"], cfg,
                             media=batch.get("media"), remat=remat)


def _xent_chunk(w, fc, lc, mc, vocab):
    logits = L.unembed({"unembed": w.to(fc.dtype)}, fc, vocab=vocab)
    return torch.sum(L.token_nll(logits, lc) * mc), torch.sum(mc)


def _chunked_xent(params, feats: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor], cfg: ModelConfig):
    """Per-chunk unembed and cross entropy, each chunk under
    ``checkpoint``: the [*, V] logits exist one sequence chunk of
    ``XENT_CHUNK`` at a time, in the forward and in the backward."""
    b, t, _ = feats.shape
    ch = XENT_CHUNK
    if t % ch:
        raise ValueError(f"chunked xent needs T % {ch} == 0, got {t}")
    m = (torch.ones((b, t), dtype=torch.float32, device=feats.device)
         if mask is None else mask.to(torch.float32))
    s = torch.zeros((), dtype=torch.float32, device=feats.device)
    c = torch.zeros((), dtype=torch.float32, device=feats.device)
    w = params["unembed"] if "unembed" in params \
        else params["embed_tokens"].T        # tied embeddings
    for i in range(t // ch):
        sl = slice(i * ch, (i + 1) * ch)
        ds, dc = checkpoint(_xent_chunk, w, feats[:, sl],
                            labels[:, sl], m[:, sl], cfg.vocab,
                            use_reentrant=False)
        s, c = s + ds, c + dc
    return s / torch.clamp(c, min=1.0)


def loss_fn(params, batch, cfg: ModelConfig, *, remat: bool = False):
    """(loss, {"loss", "xent", "aux"}) of ``batch`` ({"tokens", "labels"
    [B, T]}, optionally "loss_mask"), as the reference's: the cross
    entropy unembeds chunk by chunk at ``T >= CHUNK_XENT_T``
    (T % ``XENT_CHUNK`` == 0)."""
    t = batch["tokens"].shape[1]
    if t >= CHUNK_XENT_T and t % XENT_CHUNK == 0:
        feats, aux = _mod(cfg).forward(params, batch["tokens"], cfg,
                                       media=batch.get("media"),
                                       remat=remat, features=True)
        xent = _chunked_xent(params, feats, batch["labels"],
                             batch.get("loss_mask"), cfg)
    else:
        logits, aux = forward(params, batch, cfg, remat=remat)
        xent = L.xent_loss(logits, batch["labels"], batch.get("loss_mask"))
    loss = xent + AUX_WEIGHT * aux
    return loss, {"loss": loss, "xent": xent, "aux": aux}


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig, cache, *,
            media: Optional[torch.Tensor] = None):
    """The whole prompt from position 0, filling the contiguous cache
    (left-padded rows masked by its ``start``): (last-position logits
    [B, V], cache). encdec encodes ``media`` first and keeps its output in
    the cache for the decode steps; vlm's cross blocks attend ``media``."""
    if cfg.family == "encdec":
        enc_out = encdec.encode(params, media, cfg)
        feats, dec_cache = encdec.decode(params, tokens, enc_out, cfg,
                                         caches=cache["dec"], pos=0,
                                         features=True)
        head = transformer.cast_params(
            {k: params[k] for k in ("unembed", "embed_tokens")
             if k in params}, feats.dtype)
        logits = L.unembed(head, feats[:, -1:], vocab=cfg.vocab)
        return logits[:, -1], {"dec": dec_cache, "enc_out": enc_out}
    logits, cache = transformer.forward_cached(params, tokens, cfg, cache,
                                               pos=0, media=media,
                                               last_only=True)
    return logits[:, -1], cache


def prefill_chunk(params, tokens: torch.Tensor, cfg: ModelConfig, cache, *,
                  pos: int, last_idx: int):
    """One page-sized prompt chunk at absolute position ``pos``: fills the
    contiguous cache and returns (logits of chunk row ``last_idx``
    [B, V], cache). Rows past ``last_idx`` are right-padding whose cache
    writes land past the sequence and are causally masked. Not for
    encdec (its prefill encodes the media first: :func:`prefill`)."""
    if cfg.family == "encdec":
        raise ValueError("prefill_chunk: encdec prefills via encode/decode")
    logits, cache = transformer.forward_cached(params, tokens, cfg, cache,
                                               pos=pos)
    return logits[:, last_idx], cache


def decode_step(params, tokens: torch.Tensor, cfg: ModelConfig, cache, *,
                pos, media: Optional[torch.Tensor] = None):
    """One token step: tokens [B, 1] at positions ``pos`` ([B, 1], or an
    int). encdec's cross-attention reads the cache's ``enc_out``.
    Returns (logits [B, V], cache)."""
    if cfg.family == "encdec":
        logits, dec_cache = encdec.decode(params, tokens, cache["enc_out"],
                                          cfg, caches=cache["dec"], pos=pos)
        return logits[:, -1], {"dec": dec_cache, "enc_out": cache["enc_out"]}
    logits, cache = transformer.forward_cached(params, tokens, cfg, cache,
                                               pos=pos, media=media)
    return logits[:, -1], cache
