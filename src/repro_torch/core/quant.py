"""Quantisation with power-of-two scales: ``QuantSpec``, ``QTensor``,
``quantize``, ``dequantize``.

The port's copy of the JAX package's ``core/quant.py`` for what the
serving path needs: the per-tensor (or per-channel) scale exponent that
centres a tensor where takum precision peaks (|x| ~ 1), applied with
``ldexp`` (a multiply by an exact power of two: no rounding of its own
while results stay normal), and the round trip through a wire format.
Round to nearest even only; the STE ``fake_quant`` for training is not
in the port yet.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import posit, takum

__all__ = ["QuantSpec", "QTensor", "absmax", "exponent_of", "scale_exponent",
           "exp2i", "quantize", "dequantize"]


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    fmt: str = "takum"          # 'takum' | 'takum_lns' | 'posit' | 'none'
    n: int = 16                 # word width
    scale: str = "per_tensor"   # 'none' | 'per_tensor' | 'per_channel'
    axis: int = -1              # channel axis for per_channel
    rounding: str = "rne"       # 'rne' only in the port


@dataclasses.dataclass
class QTensor:
    """Quantised tensor: words and the power-of-two scale exponent."""
    words: torch.Tensor
    scale_exp: torch.Tensor
    spec: QuantSpec
    shape: tuple = ()

    def __post_init__(self):
        self.shape = tuple(self.shape or self.words.shape)


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


def quantize(x, spec: QuantSpec) -> QTensor:
    x = torch.as_tensor(x).to(torch.float32)
    if spec.rounding != "rne":
        raise NotImplementedError(f"rounding={spec.rounding!r}: only 'rne' "
                                  "is in the port")
    if spec.fmt == "none":
        return QTensor(x, torch.zeros((), dtype=torch.int32), spec, x.shape)
    k = scale_exponent(x, spec)
    y = _ldexp(x, k)
    if spec.fmt == "takum":
        words = takum.float_to_takum(y, spec.n)
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
