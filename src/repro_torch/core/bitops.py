"""Bit-manipulation helpers for the takum codec, on integer torch tensors.

Lane convention: PyTorch on the CPU has no ``<<``, ``>>``, ``+`` or
``where`` for ``uint16``/``uint32`` tensors, so every helper here computes
in ``int64`` lanes that hold an unsigned ``width``-bit value (``width``
defaults to 32, the JAX package's ``uint32`` compute lane). Results are
masked back to ``width`` bits wherever an unsigned lane would wrap, so the
helpers reproduce the JAX package's unsigned-lane semantics bit for bit:
shifts by ``>= width`` give 0 instead of undefined behaviour.
"""

from __future__ import annotations

import torch

__all__ = ["LANE", "mask", "safe_shl", "safe_shr", "floor_log2_u8",
           "floor_log2", "clz", "bit", "lanes", "to_words", "carrier",
           "zeros_words"]

LANE = torch.int64


def lanes(x) -> torch.Tensor:
    """Widen an integer tensor (any unsigned storage dtype) to int64 lanes."""
    x = torch.as_tensor(x)
    if x.dtype == torch.uint16:
        return x.view(torch.int16).to(LANE) & 0xFFFF
    if x.dtype == torch.uint32:
        return x.view(torch.int32).to(LANE) & 0xFFFFFFFF
    return x.to(LANE)


def carrier(t: torch.Tensor) -> torch.Tensor:
    """The same bits under a dtype every PyTorch op supports: uint16 word
    tensors are viewed as int16 for copies, indexing, padding and
    comparisons (PyTorch implements few ops for uint16); other dtypes
    pass through."""
    return t.view(torch.int16) if t.dtype == torch.uint16 else t


def zeros_words(shape, dtype: torch.dtype, device=None) -> torch.Tensor:
    """A zero-filled word tensor of ``dtype`` (allocated through its
    carrier dtype)."""
    c = torch.int16 if dtype == torch.uint16 else dtype
    return torch.zeros(shape, dtype=c, device=device).view(dtype)


def to_words(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int64 lanes holding unsigned values -> ``dtype`` words (uint8 or
    uint16; the uint16 conversion goes through int16 two's complement)."""
    if dtype == torch.uint16:
        x = torch.where(x >= 1 << 15, x - (1 << 16), x)
        return x.to(torch.int16).view(torch.uint16)
    return x.to(dtype)


def mask(nbits, width: int = 32):
    """All-ones mask of ``nbits`` bits (python int or int64 tensor),
    ``nbits`` clipped into ``[0, width]``."""
    if isinstance(nbits, int):
        nbits = min(max(nbits, 0), width)
        return (1 << nbits) - 1
    n = torch.clamp(nbits, 0, width).to(LANE)
    return (torch.ones_like(n) << n) - 1


def _as_lane(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=LANE, device=like.device)


def safe_shl(x, s, width: int = 32):
    """``x << s`` in a ``width``-bit unsigned lane: 0 for ``s >= width``."""
    x = torch.as_tensor(x, dtype=LANE)
    s = _as_lane(s, x)
    out = (x << torch.clamp(s, 0, width - 1)) & mask(width)
    return torch.where(s >= width, torch.zeros_like(out), out)


def safe_shr(x, s, width: int = 32):
    """Logical ``x >> s`` in a ``width``-bit lane: 0 for ``s >= width``."""
    x = torch.as_tensor(x, dtype=LANE)
    s = _as_lane(s, x)
    out = x >> torch.clamp(s, 0, width - 1)
    return torch.where(s >= width, torch.zeros_like(out), out)


def floor_log2_u8(x) -> torch.Tensor:
    """floor(log2(x)) for x in [1, 255]: seven compares and adds (the
    takum encoder's 8-bit leading-one detector)."""
    x = torch.as_tensor(x, dtype=LANE)
    r = torch.zeros_like(x)
    for k in range(1, 8):
        r = r + (x >= (1 << k)).to(LANE)
    return r


def floor_log2(x) -> torch.Tensor:
    """floor(log2(x)) for 1 <= x < 2**53 (exact: ``frexp`` of the float64
    value, whose exponent is the bit length)."""
    x = torch.as_tensor(x, dtype=LANE)
    _, e = torch.frexp(x.to(torch.float64))
    return (e - 1).to(LANE)


def clz(x, width: int) -> torch.Tensor:
    """Leading zeros of the low ``width`` bits of x (x < 2**width)."""
    x = torch.as_tensor(x, dtype=LANE)
    lz = width - 1 - floor_log2(torch.clamp(x, min=1))
    return torch.where(x == 0, torch.full_like(x, width), lz)


def bit(x, i, width: int = 32) -> torch.Tensor:
    """Bit ``i`` (0 = LSB) of x, 0 for ``i >= width``."""
    return safe_shr(x, i, width) & 1
