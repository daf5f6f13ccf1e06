"""``input_specs``: tensors without data standing in for every model input,
and ``dummy_batch``: small real batches for tests and examples.

The JAX package lowers its dry run against ``ShapeDtypeStruct``s; the
port traces its steps on fake tensors (``torch._subclasses.FakeTensor``,
inside the dry run's ``device.fake_cuda()``) or on ``meta`` tensors,
which carry a shape, a dtype and a device and allocate nothing. Token
ids are int64 here, where the reference's are int32: the port's
embedding lookups and losses take int64 ids (``train/trainer.py``'s
``_device_batch``). Modality frontends are stubs, as the reference's:
the batch carries precomputed frame or patch embeddings (``media``).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device

__all__ = ["input_specs", "dummy_batch", "media_shape", "AUDIO_SUBSAMPLE"]

AUDIO_SUBSAMPLE = 4  # frontend stub: one frame embedding per 4 text positions


def media_shape(cfg: ModelConfig, shape: ShapeConfig):
    """The media embeddings' shape of a cell, or None for a text model."""
    if cfg.frontend == "vision":
        return (shape.global_batch, cfg.n_media_tokens,
                cfg.d_media or cfg.d_model)
    if cfg.frontend == "audio":
        return (shape.global_batch, max(shape.seq_len // AUDIO_SUBSAMPLE, 8),
                cfg.d_model)
    return None


def input_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                device=None) -> Dict[str, Any]:
    """The batch of an (arch, shape) cell as tensors without data:
    train/prefill a full-length token batch (train with its labels),
    decode a single-token step (the cache is a separate argument);
    ``media`` float32 for the vision and audio frontends, except at
    decode. On ``device`` (``cuda`` unless given: under the dry run's
    fake mode fake CUDA tensors; ``"meta"`` gives meta tensors)."""
    dev = (torch.device("meta") if str(device) == "meta"
           else resolve_device(device))
    b, t = shape.global_batch, shape.seq_len

    def ids(n):
        return torch.empty((b, n), dtype=torch.int64, device=dev)

    if shape.kind == "train":
        out = {"tokens": ids(t), "labels": ids(t)}
    elif shape.kind == "prefill":
        out = {"tokens": ids(t)}
    else:  # decode: one new token against a seq_len-deep cache
        out = {"tokens": ids(1)}
    ms = media_shape(cfg, shape)
    if ms is not None and shape.kind != "decode":
        out["media"] = torch.empty(ms, dtype=torch.float32, device=dev)
    return out


def dummy_batch(cfg: ModelConfig, b: int, t: int, seed: int = 0,
                kind: str = "train", *, device=None) -> Dict[str, Any]:
    """A real batch of ``b`` rows of ``t`` tokens from numpy's
    ``default_rng(seed)``: the reference's draws in its order, so the
    values equal its arrays bit for bit (token ids as int64); labels for
    ``kind="train"``; seeded media for the vision and audio frontends. On
    ``device`` (``cuda`` unless given)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, t + 1), dtype=np.int32)

    def ids(a):
        return torch.from_numpy(np.ascontiguousarray(a)).long().to(dev)

    out = {"tokens": ids(toks[:, :t])}
    if kind == "train":
        out["labels"] = ids(toks[:, 1:])
    media = None
    if cfg.frontend == "vision":
        media = rng.normal(size=(b, cfg.n_media_tokens,
                                 cfg.d_media or cfg.d_model))
    elif cfg.frontend == "audio":
        media = rng.normal(size=(b, max(t // AUDIO_SUBSAMPLE, 8),
                                 cfg.d_model))
    if media is not None:
        out["media"] = torch.from_numpy(media.astype(np.float32)).to(dev)
    return out
