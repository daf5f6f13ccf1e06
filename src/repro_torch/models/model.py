"""Model API used by the serving layer (dense family)::

    init(gen, cfg)                                  -> params
    init_cache(cfg, batch, max_len)                 -> contiguous cache
    init_paged_cache(cfg, batch, num_pages, ...)    -> paged cache
    forward(params, {"tokens": tokens}, cfg)        -> (logits [B, T, V], aux)
    prefill(params, tokens, cfg, cache)             -> (logits [B, V], cache)
    prefill_chunk(params, tokens, cfg, cache, pos, last_idx)
                                                    -> (logits [B, V], cache)
    decode_step(params, tokens, cfg, cache, pos)    -> (logits [B, V], cache)

``init`` and the caches go to ``cuda`` unless the caller passes
``device="cpu"``; without a card they raise.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer

__all__ = ["init", "init_cache", "init_paged_cache", "forward", "prefill",
           "prefill_chunk", "decode_step"]


def init(gen: torch.Generator, cfg: ModelConfig, *, device=None):
    return transformer.init(gen, cfg, device=device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device=None,
               dtype=None, start=None):
    return transformer.init_cache(cfg, batch, max_len, device=device,
                                  dtype=dtype, start=start)


def init_paged_cache(cfg: ModelConfig, batch: int, num_pages: int,
                     page_size: int, max_pages: int, *, device=None,
                     dtype=None):
    return transformer.init_paged_cache(cfg, batch, num_pages, page_size,
                                        max_pages, device=device, dtype=dtype)


def forward(params, batch, cfg: ModelConfig):
    """Uncached forward over ``batch["tokens"]`` [B, T]: (logits
    [B, T, V], aux), as the reference's ``model.forward``."""
    return transformer.forward(params, batch["tokens"], cfg)


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig, cache):
    """The whole prompt from position 0, filling the contiguous cache
    (left-padded rows masked by its ``start``): (last-position logits
    [B, V], cache)."""
    logits, cache = transformer.forward_cached(params, tokens, cfg, cache,
                                               pos=0, last_only=True)
    return logits[:, -1], cache


def prefill_chunk(params, tokens: torch.Tensor, cfg: ModelConfig, cache, *,
                  pos: int, last_idx: int):
    """One page-sized prompt chunk at absolute position ``pos``: fills the
    contiguous cache and returns (logits of chunk row ``last_idx``
    [B, V], cache). Rows past ``last_idx`` are right-padding whose cache
    writes land past the sequence and are causally masked."""
    logits, cache = transformer.forward_cached(params, tokens, cfg, cache,
                                               pos=pos)
    return logits[:, last_idx], cache


def decode_step(params, tokens: torch.Tensor, cfg: ModelConfig, cache, *,
                pos):
    """One token step: tokens [B, 1] at positions ``pos`` ([B, 1]).
    Returns (logits [B, V], cache)."""
    logits, cache = transformer.forward_cached(params, tokens, cfg, cache,
                                               pos=pos)
    return logits[:, -1], cache
