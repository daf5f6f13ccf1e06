"""Dense transformer building blocks on torch tensors.

Parameters are plain dicts of tensors; a projection may instead be a
``kernels.ops.WireMatrix``, whose ``x @ w`` runs the wire-weight matmul.
``attention`` has the reference's four branches:

* the contiguous cache ``{"k", "v": [B, Tmax, Hkv, hd], "pos": int}``
  (cached prefill chunks, lockstep prefill and lockstep decode steps),
  attended through ``ops.takum_attention``;
* the paged pool ``{"k", "v": [P, ps, Hkv, hd], "table": [B, NP],
  "pos"/"start": [B]}`` (the scheduler's decode steps), through
  ``ops.paged_attention``;
* a fresh prefill (``prefill_fresh``, no ``start``, ``T >= ATTN_CHUNK_T``
  and a multiple of ``QC``): the K/V words are written to the cache, and
  attention runs over the current, unquantised k/v with
  :func:`_sdpa_chunked` (the reference computes this branch outside any
  Pallas kernel, in plain ops, as here);
* no cache (``forward``): :func:`_sdpa` under a mask, or
  :func:`_sdpa_chunked` from ``ATTN_CHUNK_T`` tokens.

New K/V are encoded to the cache's wire format and written into the cache
tensors **in place**, one fused append a layer (``ops.kv_append``; the JAX
package returns updated copies; in-place writes keep the serving loop from
copying whole caches every step). Nothing in the paged branch reads a
device value back to the host, so a decode step can be captured in a CUDA
graph (``serve/graphs.py``).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import formats
from repro_torch.core.bitops import carrier
from repro_torch.dist import tp as _tp
from repro_torch.kernels import ops
from repro_torch.kernels.cost import in_fake_mode

__all__ = ["DTYPES", "dense_init", "rmsnorm_init", "rmsnorm", "rope",
           "attn_init", "attention", "mlp_init", "mlp", "mlp_tp", "embed_init",
           "embed", "unembed", "padded_vocab", "VOCAB_PAD", "put_words",
           "causal_mask", "gelu", "ATTN_CHUNK_T", "QC", "KC", "CAUSAL_SKIP",
           "token_nll", "xent_loss"]

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
VOCAB_PAD = 128   # embedding tables padded so the vocab dim tiles evenly

ATTN_CHUNK_T = 2048   # the chunked attention from this sequence length on
QC, KC = 2048, 1024   # its query and key blocks
# skip the key blocks wholly outside the causal band in _sdpa_chunked: the
# reference's perf knob, read from the same variable, off by default
CAUSAL_SKIP = os.environ.get("REPRO_CAUSAL_SKIP", "0") == "1"


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
    # a fake tensor (the dry run's) is never kept: a real step on the
    # same device later must not find it
    fake = in_fake_mode()
    freqs = None if fake else _FREQS.get(key)
    if freqs is None:
        log_base = torch.log(torch.tensor(base, dtype=torch.float32,
                                          device=dev))
        freqs = torch.exp(-log_base * torch.arange(
            half, dtype=torch.float32, device=dev) / half)
        if not fake:
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


def _proj_qkv(params, x, xa, n_heads, n_kv_heads, head_dim, rope_base,
              positions):
    """q from ``x``, k/v from ``xa`` (cross-attention) or ``x``; RoPE on
    q and k for self-attention only."""
    b = x.shape[0]
    src = x if xa is None else xa
    q = (x @ params["wq"]).reshape(b, -1, n_heads, head_dim)
    k = (src @ params["wk"]).reshape(b, -1, n_kv_heads, head_dim)
    v = (src @ params["wv"]).reshape(b, -1, n_kv_heads, head_dim)
    if xa is not None:
        return q, k, v
    return rope(q, positions, rope_base), rope(k, positions, rope_base), v


def put_words(dst: torch.Tensor, index, src: torch.Tensor) -> None:
    """``dst[index] = src`` in place, also for uint16 words (PyTorch's
    CPU ``index_put`` has no uint16: write through an int16 view of the
    same bits)."""
    carrier(dst)[index] = carrier(src)


def _sdpa(q, k, v, mask):
    """q [B, Tq, H, hd], k/v [B, Tk, Hkv, hd]; GQA by head groups; the
    scores in f32, einsums in the inputs' dtype (the reference's)."""
    b, tq, h, hd = q.shape
    hkv = k.shape[2]
    q = q.reshape(b, tq, hkv, h // hkv, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", q, k).to(torch.float32)
    scores = scores / (hd ** 0.5)
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, tq, h, hd)


def _sdpa_chunked(q, k, v, *, window: int = 0, causal_skip: bool = False,
                  causal: bool = True):
    """Online-softmax attention over query blocks of ``QC`` and key blocks
    of ``KC`` (never the whole [Tq, Tk] scores): the reference's loop, its
    inner ``lax.scan`` a Python loop here. ``causal_skip`` visits only
    the key blocks that meet the causal (and window) band."""
    b, tq, h, hd = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    if tq % QC or tk % KC:
        raise ValueError(f"chunked attention needs Tq % {QC} == 0 and "
                         f"Tk % {KC} == 0, got {tq}, {tk}")
    q5 = q.reshape(b, tq, hkv, g, hd)
    scale = hd ** -0.5
    nkb = tk // KC
    dev = q.device
    outs = []
    for qb in range(tq // QC):
        q_blk = q5[:, qb * QC:(qb + 1) * QC]
        qpos = qb * QC + torch.arange(QC, device=dev)
        lo, hi = 0, nkb
        if causal_skip and causal:
            hi = min(nkb, qb + QC // KC + 1)
            if window:
                lo = max(0, (qb * QC - window) // KC)
        m = torch.full((b, hkv, g, QC), float("-inf"), dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, hkv, g, QC), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, hkv, g, QC, hd), dtype=v.dtype, device=dev)
        for kb in range(lo, hi):
            kc_ = k[:, kb * KC:(kb + 1) * KC]
            vc_ = v[:, kb * KC:(kb + 1) * KC]
            s = torch.einsum("bqkgd,bskd->bkgqs", q_blk, kc_)
            s = s.to(torch.float32) * scale
            if causal:
                kpos = kb * KC + torch.arange(KC, device=dev)
                msk = kpos[None, :] <= qpos[:, None]
                if window:
                    msk = msk & (kpos[None, :] > qpos[:, None] - window)
                s = torch.where(msk, s, torch.full_like(s, -1e30))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(vc_.dtype), vc_)
            acc = acc * corr[..., None].to(acc.dtype) + pv
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None].to(acc.dtype)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, QC, h, hd))
    return torch.cat(outs, dim=1)


def causal_mask(tq: int, tk: int, offset: int = 0, window: int = 0,
                device=None) -> torch.Tensor:
    """[1, 1, 1, tq, tk] bool, True = attend; ``offset`` is the position
    of query row 0."""
    qi = torch.arange(tq, device=device)[:, None] + offset
    kj = torch.arange(tk, device=device)[None, :]
    m = kj <= qi
    if window:
        m = m & (kj > qi - window)
    return m[None, None, None]


def attention(params, x: torch.Tensor, cfg, positions: torch.Tensor, *,
              xa: Optional[torch.Tensor] = None,
              cache: Optional[Dict[str, Any]] = None, mask=None,
              window: int = 0, bidirectional: bool = False,
              prefill_fresh: bool = False):
    """Self-attention, with a decode cache or without, or cross-attention
    to ``xa [B, Tk, d]`` (K/V projected from ``xa``, no RoPE, no cache:
    :func:`_sdpa` under ``mask``, as the reference's); returns (out,
    new_cache), ``new_cache`` None without a cache.

    The cache's K/V tensors are updated in place; ``new_cache`` carries
    the advanced ``pos``."""
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v = _proj_qkv(params, x, xa, h, hkv, hd, cfg.rope_base, positions)
    t = x.shape[1]
    new_cache = None
    if xa is not None:
        out = _sdpa(q, k, v, mask)
    elif cache is None:
        if t >= ATTN_CHUNK_T and t % QC == 0 and k.shape[1] % KC == 0:
            out = _sdpa_chunked(q, k, v, window=window,
                                causal_skip=CAUSAL_SKIP,
                                causal=not bidirectional)
        else:
            out = _sdpa(q, k, v, mask)
    elif "table" in cache:
        spec = formats.resolve(cfg.kv_quant)
        # paged decode step: append this step's words at
        # (table[b, pos // ps], pos % ps), then attend through the block
        # table. Idle slots keep stepping with a stale pos: the block
        # index is clamped to the table width (they point at page 0).
        if t != 1:
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
        spec = formats.resolve(cfg.kv_quant)
        # contiguous cache at absolute position pos
        pos = int(cache["pos"])
        if pos + t > cache["k"].shape[1]:
            raise ValueError(f"cache of {cache['k'].shape[1]} positions "
                             f"cannot take {t} more at {pos}")
        ops.kv_append(k, v, cache["k"], cache["v"], spec, pos=pos)
        new_cache = dict(cache, pos=pos + t)
        if (prefill_fresh and "start" not in cache
                and t >= ATTN_CHUNK_T and t % QC == 0):
            # fresh prefill: the words are in the cache, and attention
            # runs over the current, unquantised k/v in the activation
            # dtype (the reference assumes pos == 0 here, as its serving
            # flows guarantee)
            out = _sdpa_chunked(q, k, v, window=window,
                                causal_skip=CAUSAL_SKIP, causal=True)
        else:
            out = ops.takum_attention(q, cache["k"], cache["v"], spec.n,
                                      spec, pos=pos,
                                      start=cache.get("start"),
                                      window=window,
                                      block=cfg.kv_block or None).to(x.dtype)
    out = out.reshape(x.shape[0], t, h * hd)
    # the TP seam (dist.tp): ``out @ wo`` outside a sharded step; inside
    # one, the all-gather or all-reduce (the error-feedback residual is
    # updated in the cache dict, where serve/shard.py put one)
    return _tp.attn_out(out, params["wo"], new_cache)


def mlp_init(gen, d_model, d_ff, activation, dtype=torch.float32,
             device=None):
    """SwiGLU's ``{wg, w1, w2}``, or ``{w1, w2}`` for relu2 and gelu."""
    kw = dict(dtype=dtype, device=device)
    if activation not in ("swiglu", "relu2", "gelu"):
        raise ValueError(f"unknown activation {activation!r}")
    p = {"wg": dense_init(gen, d_model, d_ff, **kw)} \
        if activation == "swiglu" else {}
    p["w1"] = dense_init(gen, d_model, d_ff, **kw)
    p["w2"] = dense_init(gen, d_ff, d_model, **kw)
    return p


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU in its tanh approximation, ``jax.nn.gelu``'s default
    (``F.gelu``'s own default is the exact erf form)."""
    return F.gelu(x, approximate="tanh")


def mlp(params, x: torch.Tensor, activation: str) -> torch.Tensor:
    """SwiGLU (silu(x @ wg) * (x @ w1)) @ w2, relu2 relu(x @ w1)^2 @ w2 or
    gelu gelu(x @ w1) @ w2."""
    return mlp_tp(params, x, activation)[0]


def mlp_tp(params, x: torch.Tensor, activation: str, state=None):
    """:func:`mlp` with its TP seam exposed: ``(out, state)``. ``state`` is
    the layer's attention-cache dict, passed to ``dist.tp.mlp_out`` so
    the down-projection's error-feedback residual (``tp_res_m``) lives
    beside the layer's KV pages; the plain ``hid @ w2`` without an active
    TP context."""
    if activation == "swiglu":
        hid = F.silu(x @ params["wg"]) * (x @ params["w1"])
    elif activation == "relu2":
        hid = torch.relu(x @ params["w1"]) ** 2
    elif activation == "gelu":
        hid = gelu(x @ params["w1"])
    else:
        raise ValueError(f"unknown activation {activation!r}")
    return _tp.mlp_out(hid, params["w2"], state)


def padded_vocab(vocab: int) -> int:
    return -(-vocab // VOCAB_PAD) * VOCAB_PAD


def embed_init(gen, vocab, d_model, tie: bool = False, dtype=torch.float32,
               device=None):
    """``embed_tokens [Vp, d]`` and, unless ``tie``, ``unembed [d, Vp]``
    (a tied model unembeds by ``embed_tokens``' transpose)."""
    vp = padded_vocab(vocab)
    p = {"embed_tokens": torch.randn((vp, d_model), generator=gen,
                                     dtype=dtype, device=device).mul_(0.02)}
    if not tie:
        p["unembed"] = dense_init(gen, d_model, vp, dtype=dtype,
                                  device=device)
    return p


def embed(params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return params["embed_tokens"][tokens].to(dtype)


def unembed(params, x: torch.Tensor, vocab: Optional[int] = None):
    """x @ ``unembed``, or, tied, x @ ``embed_tokens``^T in x's dtype;
    f32 logits without the vocab padding."""
    w = params["unembed"] if "unembed" in params \
        else params["embed_tokens"].T.to(x.dtype)
    # the DP seam (dist.tp): ``x @ w`` outside a sharded step; inside one,
    # the batch rows shard over the data axis and the logits all-gather
    logits = _tp.unembed_rows(x, w).to(torch.float32)
    if vocab is not None and logits.shape[-1] != vocab:
        logits = logits[..., :vocab]     # drop the vocab padding
    return logits


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token negative log-likelihood in f32; labels [B, T] integer."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return logz - gold


def xent_loss(logits: torch.Tensor, labels: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy in f32; labels [B, T] integer."""
    nll = token_nll(logits, labels)
    if mask is None:
        return torch.mean(nll)
    mask = mask.to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
