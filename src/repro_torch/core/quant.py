"""Quantisation with power-of-two scales: ``QuantSpec``, ``QTensor``,
``quantize``, ``dequantize``, ``fake_quant``.

The port's copy of the JAX package's ``core/quant.py``: the per-tensor
(or per-channel) scale exponent that centres a tensor where takum
precision peaks (|x| ~ 1), applied with ``ldexp`` (a multiply by an
exact power of two: no rounding of its own while results stay normal),
and the round trip through a wire format. Linear takum words may round
stochastically (``rounding="sr"``, n >= 12), from uniform bits drawn
from an explicit ``torch.Generator``. ``fake_quant`` is the round trip
with the straight-through gradient (the backward returns ``g``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core import posit, takum

__all__ = ["QuantSpec", "QTensor", "absmax", "exponent_of", "scale_exponent",
           "exp2i", "quantize", "dequantize", "fake_quant"]


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    fmt: str = "takum"          # 'takum' | 'takum_lns' | 'posit' | 'none'
    n: int = 16                 # word width
    scale: str = "per_tensor"   # 'none' | 'per_tensor' | 'per_channel'
    axis: int = -1              # channel axis for per_channel
    rounding: str = "rne"       # 'rne' | 'sr' (linear takum, n >= 12)

    @property
    def bits(self) -> int:
        """Bits on the wire per element (32 for the f32 ``none``)."""
        return 32 if self.fmt == "none" else self.n

    @property
    def compression(self) -> float:
        """Against f32."""
        return 32.0 / self.bits


@dataclasses.dataclass
class QTensor:
    """Quantised tensor: words and the power-of-two scale exponent."""
    words: torch.Tensor
    scale_exp: torch.Tensor
    spec: QuantSpec
    shape: tuple = ()

    def __post_init__(self):
        self.shape = tuple(self.shape or self.words.shape)

    @property
    def nbytes_wire(self) -> int:
        """Bytes of the words packed at ``spec.bits`` bits each (what a
        wire carries; storage pads an n-bit word to its word dtype)."""
        return math.prod(self.shape) * self.spec.bits // 8


def absmax(x: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """max |x| per tensor, or per channel (``keepdim`` shape)."""
    ax = x.abs()
    if spec.scale == "per_tensor":
        return ax.max()
    axis = spec.axis % x.ndim
    return ax.amax(dim=tuple(i for i in range(x.ndim) if i != axis),
                   keepdim=True)


def exponent_of(m: torch.Tensor) -> torch.Tensor:
    """int32 k = -floor(log2(m)) from the f32 exponent field, so that
    m * 2^k lies in [1, 2); m == 0 gives 0."""
    m = torch.where(m == 0, torch.ones_like(m), m)
    k = (m.to(torch.float32).view(torch.int32) >> 23) - 127
    return (-k).to(torch.int32)


def scale_exponent(x: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """The power-of-two exponent that centres ``x`` (per tensor or per
    channel) where takum precision peaks; 0 for ``scale="none"``."""
    if spec.scale == "none":
        return torch.zeros((), dtype=torch.int32, device=x.device)
    return exponent_of(absmax(x, spec))


def exp2i(k) -> torch.Tensor:
    """2^k as f32, assembled from its bits (exact for -149 <= k <= 127;
    every scale exponent lies in [-127, 127])."""
    k = torch.as_tensor(k).to(torch.int32)
    bits = torch.where(k >= -126, (k + 127) << 23,
                       torch.ones_like(k) << torch.clamp(k + 149, 0, 22))
    return bits.view(torch.float32)


def _ldexp(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """x * 2^k: one multiply by an exact power of two."""
    return x * exp2i(k).to(x.device)


def _rng_bits(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Uniform uint32 lanes of ``x``'s shape, drawn from ``generator``
    (on ``x``'s device)."""
    r = torch.randint(0, 1 << 32, x.shape, generator=generator,
                      dtype=torch.int64, device=x.device)
    return torch.where(r >= 1 << 31, r - (1 << 32), r).to(
        torch.int32).view(torch.uint32)


def quantize(x, spec: QuantSpec, *,
             generator: Optional[torch.Generator] = None) -> QTensor:
    """``x`` -> words and scale exponent. ``spec.rounding == "sr"`` draws
    the stochastic rounding's bits from ``generator`` (required: there is
    no global seed), and takes linear takum words only."""
    x = torch.as_tensor(x).to(torch.float32)
    if spec.rounding not in ("rne", "sr"):
        raise ValueError(f"unknown rounding {spec.rounding!r}")
    if spec.fmt == "none":
        return QTensor(x, torch.zeros((), dtype=torch.int32), spec, x.shape)
    k = scale_exponent(x, spec)
    y = _ldexp(x, k)
    rng_bits = None
    if spec.rounding == "sr":
        if generator is None:
            raise ValueError("sr quantisation needs a torch.Generator")
        if spec.fmt != "takum":
            raise ValueError(f"sr rounding is defined for linear takum "
                             f"words, not {spec.fmt!r}")
        rng_bits = _rng_bits(y, generator)
    if spec.fmt == "takum":
        words = takum.float_to_takum(y, spec.n, rounding=spec.rounding,
                                     rng_bits=rng_bits)
    elif spec.fmt == "takum_lns":
        words = takum.float_to_lns_takum(y, spec.n)
    elif spec.fmt == "posit":
        words = posit.float_to_posit(y, spec.n)
    else:
        raise ValueError(f"unknown format {spec.fmt}")
    return QTensor(words, k, spec, x.shape)


def dequantize(qt: QTensor, dtype=torch.float32) -> torch.Tensor:
    spec = qt.spec
    if spec.fmt == "none":
        return qt.words.to(dtype)
    if spec.fmt == "takum":
        y = takum.takum_to_float(qt.words, spec.n, dtype=dtype)
    elif spec.fmt == "takum_lns":
        y = takum.lns_takum_to_float(qt.words, spec.n, dtype=dtype)
    elif spec.fmt == "posit":
        y = posit.posit_to_float(qt.words, spec.n, dtype=dtype)
    else:
        raise ValueError(f"unknown format {spec.fmt}")
    return _ldexp(y, -qt.scale_exp).to(dtype)


class _FakeQuant(torch.autograd.Function):
    """Quantise-dequantise forward, straight-through backward."""

    @staticmethod
    def forward(ctx, x, spec):
        ctx.dtype = x.dtype
        return dequantize(quantize(x, spec))

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None   # STE: takum's range never clips


def fake_quant(x: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """``dequantize(quantize(x, spec))`` (f32) with a straight-through
    gradient: the backward passes ``g`` through unchanged, as the JAX
    package's ``custom_vjp`` does. Used for quantisation-aware
    training."""
    return _FakeQuant.apply(x, spec)
