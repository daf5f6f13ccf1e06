"""Bit-manipulation helpers for the takum codec, on integer torch tensors.

Lane convention: PyTorch on the CPU has no ``<<``, ``>>``, ``+`` or
``where`` for ``uint16``/``uint32`` tensors, so every helper here computes
in ``int64`` lanes that hold an unsigned ``width``-bit value (``width``
defaults to 32, the JAX package's ``uint32`` compute lane). Results are
masked back to ``width`` bits wherever an unsigned lane would wrap, so the
helpers reproduce the JAX package's unsigned-lane semantics bit for bit:
shifts by ``>= width`` give 0 instead of undefined behaviour. A wider
``width`` (up to 62) holds the hardware path's (n + 7)-bit extended takum;
``>>`` on ``int64`` is arithmetic, so a helper masks after every right
shift of a value that may have bit 63 set (``ashr`` sign-extends on
purpose).

Words travel in ``uint8``/``uint16``/``uint32`` storage (``word_dtype``):
widths 6 <= n <= 32. A 64-bit word does not fit: its sign bit is the
int64 lane's own, and ``mask(64)`` is not an int64 value, so n > 32 is
refused by name.
"""

from __future__ import annotations

import torch

__all__ = ["LANE", "mask", "safe_shl", "safe_shr", "ashr", "floor_log2_u8",
           "lod8_lut", "floor_log2", "popcount", "clz", "bit", "lanes",
           "to_words", "carrier", "zeros_words", "word_dtype", "MAX_WIDTH"]

LANE = torch.int64
MAX_WIDTH = 32        # widest word in int64 lanes (see the module doc)
_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32}


def word_dtype(n: int) -> torch.dtype:
    """Narrowest unsigned storage dtype for an n-bit word (n <= 32)."""
    if n <= 8:
        return torch.uint8
    if n <= 16:
        return torch.uint16
    if n <= MAX_WIDTH:
        return torch.uint32
    raise ValueError(f"{n}-bit words are not supported: the port's int64 "
                     f"lanes hold words of at most {MAX_WIDTH} bits (a "
                     "64-bit word's sign bit is the lane's own)")


def lanes(x) -> torch.Tensor:
    """Widen an integer tensor (any unsigned storage dtype) to int64 lanes."""
    x = torch.as_tensor(x)
    if x.dtype == torch.uint16:
        return x.view(torch.int16).to(LANE) & 0xFFFF
    if x.dtype == torch.uint32:
        return x.view(torch.int32).to(LANE) & 0xFFFFFFFF
    return x.to(LANE)


def carrier(t: torch.Tensor) -> torch.Tensor:
    """The same bits under a dtype every PyTorch op supports: uint16 and
    uint32 word tensors are viewed as int16 / int32 for copies, indexing,
    padding and comparisons (PyTorch implements few ops for them); other
    dtypes pass through."""
    return t.view(_SIGNED[t.dtype]) if t.dtype in _SIGNED else t


def zeros_words(shape, dtype: torch.dtype, device=None) -> torch.Tensor:
    """A zero-filled word tensor of ``dtype`` (allocated through its
    carrier dtype)."""
    c = _SIGNED.get(dtype, dtype)
    return torch.zeros(shape, dtype=c, device=device).view(dtype)


def to_words(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int64 lanes holding unsigned values -> ``dtype`` words (uint8,
    uint16 or uint32; the wider two through their signed two's
    complement)."""
    if dtype in _SIGNED:
        bits = 16 if dtype == torch.uint16 else 32
        x = torch.where(x >= 1 << (bits - 1), x - (1 << bits), x)
        return x.to(_SIGNED[dtype]).view(dtype)
    return x.to(dtype)


def mask(nbits, width: int = 32):
    """All-ones mask of ``nbits`` bits (python int or int64 tensor),
    ``nbits`` clipped into ``[0, width]`` (``width`` at most 62)."""
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
    out = (x << torch.clamp(s, 0, width - 1)) & mask(width, width)
    return torch.where(s >= width, torch.zeros_like(out), out)


def safe_shr(x, s, width: int = 32):
    """Logical ``x >> s`` in a ``width``-bit lane: 0 for ``s >= width``."""
    x = torch.as_tensor(x, dtype=LANE)
    s = _as_lane(s, x)
    out = x >> torch.clamp(s, 0, width - 1)
    return torch.where(s >= width, torch.zeros_like(out), out)


def ashr(x, s, width: int) -> torch.Tensor:
    """Arithmetic right shift of the ``width``-bit two's-complement value
    held in the low bits of ``x``, masked back to ``width`` bits (the
    paper's Table I bias by an arithmetic shift). Shifts past the width
    leave the sign bits."""
    x = torch.as_tensor(x, dtype=LANE)
    v = x - (((x >> (width - 1)) & 1) << width)       # sign-extended
    return (v >> torch.clamp(_as_lane(s, v), 0, 62)) & mask(width, 62)


def floor_log2_u8(x) -> torch.Tensor:
    """floor(log2(x)) for x in [1, 255]: seven compares and adds (the
    takum encoder's 8-bit leading-one detector)."""
    x = torch.as_tensor(x, dtype=LANE)
    r = torch.zeros_like(x)
    for k in range(1, 8):
        r = r + (x >= (1 << k)).to(LANE)
    return r


def lod8_lut(x) -> torch.Tensor:
    """The hardware-faithful 8-bit leading-one detector of section V-C
    (after Ebrahimi et al.): a 4-bit table on each nibble, the high
    result (+4) when any high bit is set. Equals :func:`floor_log2_u8`
    on [1, 255]."""
    x = torch.as_tensor(x, dtype=LANE)
    lo, hi = x & 0xF, (x >> 4) & 0xF

    def lut4(v):      # offset of the MSB of 4 bits (0 for v in {0, 1})
        return ((v >= 8).to(LANE) * 3 + ((v >= 4) & (v < 8)).to(LANE) * 2
                + ((v >= 2) & (v < 4)).to(LANE))

    return torch.where(hi != 0, lut4(hi) + 4, lut4(lo))


def popcount(x) -> torch.Tensor:
    """Set bits of non-negative int64 lanes (SWAR sums of pairs, nibbles,
    then bytes; no product, so nothing wraps)."""
    x = torch.as_tensor(x, dtype=LANE)
    x = x - ((x >> 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + ((x >> 2) & 0x3333333333333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F0F0F0F0F
    for s in (8, 16, 32):
        x = x + (x >> s)
    return x & 0x7F


def _smear(x, width: int = 32) -> torch.Tensor:
    """Propagate the MSB down: every bit at or below it set."""
    x = torch.as_tensor(x, dtype=LANE)
    s = 1
    while s < width:
        x = x | (x >> s)
        s *= 2
    return x


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
