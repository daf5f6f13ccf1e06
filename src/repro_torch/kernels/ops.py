"""Public ops around the kernels: shapes, padding, layouts, dispatch.

Every entry point resolves its format once here (a ``FormatSpec``, a
registry name such as ``"takum8"``, ``"lns-takum8"`` or ``"posit8"``, or
an int width meaning linear takum, or LNS takum for :func:`lns_matmul`)
and puts the tensors into the kernel's layout. The kernel wrappers of
``takum_codec``/``takum_matmul``/``lns_matmul``/``takum_attention``/
``quantize`` choose the path: CUDA tensors launch the hand-written
kernel (or raise: there is no fallback), CPU tensors run the plain
version of ``kernels/ref.py``. The two wire matmuls are
``torch.autograd.Function``s with the reference's VJP.
"""

from __future__ import annotations

import torch

from repro_torch import formats
from repro_torch.kernels import lns_matmul as klns
from repro_torch.kernels import takum_attention as kattn
from repro_torch.kernels import quantize, takum_codec, takum_matmul

__all__ = ["takum_decode", "takum_encode", "kv_append", "fake_quant_fused",
           "quant_matmul", "lns_matmul", "takum_attention", "paged_attention",
           "WireMatrix"]


def takum_decode(words: torch.Tensor, fmt,
                 dtype=torch.float32) -> torch.Tensor:
    """Wire words (any shape) -> ``dtype`` (f32 and f64 decoded directly,
    other float dtypes from f32); zero word -> 0.0, NaR -> NaN."""
    spec = formats.resolve(fmt)
    if spec.is_identity:
        return words.to(dtype)
    return takum_codec.decode(words, spec, dtype=dtype)


def takum_encode(x: torch.Tensor, fmt) -> torch.Tensor:
    """Floats (any shape, cast to f32) -> wire words, RNE, saturating."""
    return takum_codec.encode(x, formats.resolve_wire(fmt))


def kv_append(k: torch.Tensor, v: torch.Tensor, k_cache: torch.Tensor,
              v_cache: torch.Tensor, fmt, *, pos, table=None) -> None:
    """Write fresh ``k``/``v [B, T, Hkv, hd]`` into a KV cache in place,
    in the cache's format (one launch of the fused append on CUDA): a
    paged pool through ``table [B, NP]`` at the device ``pos [B]``, or a
    contiguous cache at ``[:, pos:pos + T]``."""
    takum_codec.kv_append(k, v, k_cache, v_cache, formats.resolve(fmt),
                          pos=pos, table=table)


def fake_quant_fused(x: torch.Tensor, n=None, *, dtype=torch.float32,
                     fmt="linear") -> torch.Tensor:
    """Quantise-dequantise through a wire format's grid in one pass (the
    fused kernel on CUDA: one read and one write per element).

    ``(fmt, n)`` resolve through the registry: ``"linear"``, ``"lns"`` or
    ``"posit"`` with a width, or a name or spec on its own. No scaling
    (that is ``FormatSpec.fake_quant``'s policy). Input of any shape is
    cast to f32; the output has its shape in ``dtype`` (f32 or bf16)."""
    return quantize.fake_quant(x, formats.resolve_wire(fmt, n), dtype=dtype)


def _dense_wire_spec(fmt):
    """A float-decoding wire format; LNS words take :func:`lns_matmul`."""
    spec = formats.resolve_wire(fmt)
    if spec.has_lns_parts:
        raise ValueError(f"format {spec.name!r} is on the LNS ℓ̄ datapath; "
                         "use ops.lns_matmul for it")
    return spec


def _lns_wire_spec(fmt):
    """An LNS wire format (a bare int width means lns-takum<n>)."""
    spec = formats.resolve_lns(fmt)
    if not spec.has_lns_parts:
        raise ValueError(f"format {spec.name!r} has no LNS ℓ̄ datapath; "
                         "use ops.quant_matmul for float-decoding wire "
                         "formats")
    return spec


class _WireMatmul(torch.autograd.Function):
    """A wire matmul's forward (``fwd(x2, w_words)`` on the rows of x) and
    the reference's VJP: the weights are wire-format constants, so the
    only cotangent is ``g @ decode(w)^T`` (straight through any rounding
    of x on the way in), the decode through the codec kernel on CUDA."""

    @staticmethod
    def forward(ctx, x, w_words, spec, fwd):
        ctx.save_for_backward(w_words)
        ctx.spec, ctx.dtype = spec, x.dtype
        out = fwd(x.reshape(-1, x.shape[-1]), w_words)
        return out.reshape(*x.shape[:-1], w_words.shape[1])

    @staticmethod
    def backward(ctx, g):
        (w_words,) = ctx.saved_tensors
        w = takum_decode(w_words, ctx.spec)
        return torch.matmul(g, w.t()).to(ctx.dtype), None, None, None


def quant_matmul(x: torch.Tensor, w_words: torch.Tensor, fmt) -> torch.Tensor:
    """x [..., K] @ decode(w_words [K, N]) -> [..., N] f32; rows of any
    leading shape are flattened into the kernel's M. Linear takum and
    posit words: LNS words are refused (see :func:`lns_matmul`).
    Differentiable in x (``g @ decode(w)^T``); ``w_words`` gets no
    gradient."""
    spec = _dense_wire_spec(fmt)
    return _WireMatmul.apply(
        x, w_words, spec, lambda x2, w: takum_matmul.qmatmul(x2, w, spec))


def lns_matmul(x: torch.Tensor, w_words: torch.Tensor, fmt,
               accum: str = "linear") -> torch.Tensor:
    """x [..., K] (x) decode(w_words [K, N]) -> [..., N] f32 on the LNS
    ell_bar datapath.

    ``w_words`` are logarithmic takum words; ``x`` (any float dtype) is
    encoded to the same LNS grid on the way in (the codec's LNS encode
    kernel on CUDA), so every product is one int32 add. ``accum="linear"``
    converts each product and sums in f32; ``"gauss"`` folds the products
    through the Gauss-log table and converts once per output. Linear takum
    words are refused (see :func:`quant_matmul`). Differentiable in x
    with a straight-through estimate through the activation encode
    (``g @ decode(w)^T``); on the plain path ``"gauss"`` refuses a
    gradient, as the reference's plain fallback does."""
    spec = _lns_wire_spec(fmt)
    if (accum == "gauss" and not x.is_cuda and torch.is_grad_enabled()
            and x.requires_grad):
        raise ValueError("accum='gauss' has no gradient on the plain path: "
                         "differentiate the kernel path (CUDA tensors) or "
                         "accumulate with accum='linear'")

    def fwd(x2, w):
        xw = takum_codec.encode(x2.to(torch.float32), spec)
        return klns.lns_matmul(xw, w, spec, accum)
    return _WireMatmul.apply(x, w_words, spec, fwd)


def _check_heads(h: int, hkv: int) -> None:
    if h % hkv:
        raise ValueError(f"n_heads {h} not a multiple of n_kv_heads {hkv}")


def takum_attention(q, k_cache, v_cache, n=0, fmt="none", *, pos: int,
                    start=None, window: int = 0, block=None) -> torch.Tensor:
    """Attention of ``q [B, tq, H, hd]`` over a contiguous wire cache
    ``[B, Tmax, Hkv, hd]``, words decoded inside the kernel. ``pos`` is
    the position of ``q[:, 0]``, ``start [B]`` the first valid key,
    ``window`` a sliding window (0 = full causal), ``block`` the KV tile
    (default 256, clamped to Tmax rounded up to 8). Returns
    ``[B, tq, H, hd]`` f32."""
    spec = formats.resolve(fmt, n)
    tq, h = q.shape[1], q.shape[2]
    hkv = k_cache.shape[2]
    _check_heads(h, hkv)
    out4 = kattn.attention(kattn.to_rows(q, hkv), k_cache, v_cache, pos,
                           start, spec=spec, tq=tq, bk=block, window=window)
    return kattn.from_rows(out4, tq)


def paged_attention(q, k_pool, v_pool, table, fmt="none", *, pos,
                    start=None, window: int = 0) -> torch.Tensor:
    """One decode step (``q [B, 1, H, hd]``) over a paged wire cache
    ``[P, ps, Hkv, hd]`` through the block table ``[B, NP]``; ``pos`` and
    ``start`` are per-sequence ``[B]`` vectors. Returns
    ``[B, 1, H, hd]`` f32."""
    spec = formats.resolve(fmt)
    tq, h = q.shape[1], q.shape[2]
    if tq != 1:
        raise ValueError(
            f"paged_attention is decode-only (tq == 1), got tq={tq}; "
            "prefill runs on the contiguous cache and is scattered into "
            "pages by the scheduler")
    hkv = k_pool.shape[2]
    _check_heads(h, hkv)
    out4 = kattn.paged_attention(kattn.to_rows(q, hkv), k_pool, v_pool, pos,
                                 start, table, spec=spec, window=window)
    return kattn.from_rows(out4, 1)


class WireMatrix:
    """A [K, N] weight held as wire words and decoded inside the matmul.

    Drop-in for a float matrix at ``x @ w`` sites: torch defers the
    product to :meth:`__rmatmul__`, which routes it through
    :func:`lns_matmul` for LNS words (the ell_bar-datapath kernel on CUDA,
    linear accumulation) and :func:`quant_matmul` for linear takum and
    posit words (the wire-weight kernel on CUDA); both are
    differentiable in x."""

    def __init__(self, words: torch.Tensor, n=None, *, fmt="linear"):
        self.spec = formats.resolve_wire(fmt, n)
        if words.dtype != self.spec.word_dtype or words.ndim != 2:
            raise TypeError(f"WireMatrix takes 2D {self.spec.word_dtype} "
                            f"words, got {words.dtype} {tuple(words.shape)}")
        self.words = words

    @classmethod
    def encode(cls, w: torch.Tensor, n=None, *, fmt="linear") -> "WireMatrix":
        spec = formats.resolve_wire(fmt, n)
        return cls(takum_codec.encode(w.to(torch.float32), spec), fmt=spec)

    @property
    def shape(self):
        return self.words.shape

    @property
    def dtype(self):   # decode target dtype, for callers probing params
        return torch.float32

    def to(self, device) -> "WireMatrix":
        return WireMatrix(self.words.to(device), fmt=self.spec)

    def decode(self, dtype=torch.float32) -> torch.Tensor:
        return takum_decode(self.words, self.spec, dtype=dtype)

    def __rmatmul__(self, x: torch.Tensor) -> torch.Tensor:
        if self.spec.has_lns_parts:
            out = lns_matmul(x, self.words, self.spec, "linear")
        else:
            out = quant_matmul(x, self.words, self.spec)
        return out.to(x.dtype)

    def __repr__(self):
        return (f"WireMatrix(shape={tuple(self.words.shape)}, "
                f"spec={self.spec.name!r})")
