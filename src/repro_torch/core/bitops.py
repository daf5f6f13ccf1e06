"""Bit-manipulation helpers for the takum codec, on integer torch tensors.

Lane convention: PyTorch on the CPU has no ``<<``, ``>>``, ``+``, ``<`` or
``where`` for ``uint16``/``uint32``/``uint64`` tensors (only ``&``, ``|``,
``^``, ``*``, casts and ``view``), so every helper here computes in
``int64`` lanes that hold an unsigned ``width``-bit value (``width`` is
32, the JAX package's ``uint32`` compute lane for n <= 32, or 64, its
``uint64`` lane under x64 for 33 <= n <= 64). Results are masked back to
``width`` bits wherever an unsigned lane would wrap, so the helpers
reproduce the JAX package's unsigned-lane semantics bit for bit: shifts
by ``>= width`` give 0 instead of undefined behaviour. A wider ``width``
(up to 62) holds intermediate values such as the hardware path's
characteristic.

A 64-bit unsigned value lives in an int64 lane as the same 64 bits: bit
63 is the lane's sign bit, so such a lane may be negative. Adds,
subtracts, products, ``&``/``|``/``^``/``~`` and ``<<`` give the same
bits as uint64 arithmetic (int64 wraps modulo 2^64); ``mask(64)`` is
``-1``; a logical right shift masks after ``>>``, which is arithmetic
(:func:`safe_shr`); :func:`floor_log2` (at ``width`` 64), :func:`clz`
and :func:`popcount` read all 64 bits. The codec orders no 64-bit lanes: its saturation tests
are equalities (an ordered compare would flip both sign bits first, ``x
^ (1 << 63)``). Python ints at or above 2^63 are written as their int64
two's complement (:func:`signed64`).

Words travel in ``uint8``/``uint16``/``uint32``/``uint64`` storage
(``word_dtype``): widths 6 <= n <= 64, n > 64 refused by name.
"""

from __future__ import annotations

import torch

__all__ = ["LANE", "mask", "safe_shl", "safe_shr", "ashr", "floor_log2_u8",
           "lod8_lut", "floor_log2", "popcount", "clz", "bit", "lanes",
           "to_words", "carrier", "zeros_words", "word_dtype", "MAX_WIDTH",
           "lane_width", "signed64"]

LANE = torch.int64
MAX_WIDTH = 64        # widest word: uint64 storage, int64 lanes
_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32,
           torch.uint64: torch.int64}


def word_dtype(n: int) -> torch.dtype:
    """Narrowest unsigned storage dtype for an n-bit word (n <= 64)."""
    if n <= 8:
        return torch.uint8
    if n <= 16:
        return torch.uint16
    if n <= 32:
        return torch.uint32
    if n <= MAX_WIDTH:
        return torch.uint64
    raise ValueError(f"unsupported word width n={n}: words take "
                     f"6 <= n <= {MAX_WIDTH} bits")


def lane_width(n: int) -> int:
    """The unsigned compute lane of an n-bit codec: 32 bits for n <= 32,
    64 above (the reference's ``compute_dtype``)."""
    return 32 if n <= 32 else 64


def signed64(v: int) -> int:
    """A Python int in [0, 2^64) as the int64 lane holding its bits."""
    return v - (1 << 64) if v >= 1 << 63 else v


def lanes(x) -> torch.Tensor:
    """Widen an integer tensor (any unsigned storage dtype) to int64 lanes
    (uint64 words keep their 64 bits: see the module doc)."""
    x = torch.as_tensor(x)
    if x.dtype == torch.uint64:
        return x.view(torch.int64)
    if x.dtype == torch.uint16:
        return x.view(torch.int16).to(LANE) & 0xFFFF
    if x.dtype == torch.uint32:
        return x.view(torch.int32).to(LANE) & 0xFFFFFFFF
    return x.to(LANE)


def carrier(t: torch.Tensor) -> torch.Tensor:
    """The same bits under a dtype every PyTorch op supports: uint16,
    uint32 and uint64 word tensors are viewed as int16 / int32 / int64 for
    copies, indexing,
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
    uint16, uint32 or uint64; the wider three through their signed two's
    complement, uint64 as the lane's own bits)."""
    if dtype == torch.uint64:
        return x.to(LANE).view(torch.uint64)
    if dtype in _SIGNED:
        bits = 16 if dtype == torch.uint16 else 32
        x = torch.where(x >= 1 << (bits - 1), x - (1 << bits), x)
        return x.to(_SIGNED[dtype]).view(dtype)
    return x.to(dtype)


def mask(nbits, width: int = 32):
    """All-ones mask of ``nbits`` bits (python int or int64 tensor),
    ``nbits`` clipped into ``[0, width]``; ``mask(64, 64)`` is -1."""
    if isinstance(nbits, int):
        nbits = min(max(nbits, 0), width)
        return signed64((1 << nbits) - 1)
    n = torch.clamp(nbits, 0, width).to(LANE)
    out = (torch.ones_like(n) << torch.clamp(n, max=63)) - 1
    return torch.where(n >= 64, torch.full_like(out, -1), out)


def _as_lane(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=LANE, device=like.device)


def safe_shl(x, s, width: int = 32):
    """``x << s`` in a ``width``-bit unsigned lane: 0 for ``s >= width``."""
    x = torch.as_tensor(x, dtype=LANE)
    s = _as_lane(s, x)
    out = (x << torch.clamp(s, 0, width - 1)) & mask(width, width)
    return torch.where(s >= width, torch.zeros_like(out), out)


def safe_shr(x, s, width: int = 32):
    """Logical ``x >> s`` in a ``width``-bit lane: 0 for ``s >= width``
    (at ``width`` 64 the arithmetic shift's sign bits masked off)."""
    x = torch.as_tensor(x, dtype=LANE)
    s = _as_lane(s, x)
    sc = torch.clamp(s, 0, width - 1)
    out = x >> sc
    if width == 64:
        out = out & mask(64 - sc, 64)
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
    """Set bits of the 64 bits of each int64 lane (SWAR sums of pairs,
    nibbles, then bytes; the masks after each ``>>`` drop the arithmetic
    shift's sign bits, and no product wraps)."""
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


def _floor_log2_53(x) -> torch.Tensor:
    """floor(log2(x)) for 0 <= x < 2**53 (-1 for 0): ``frexp`` of the
    float64 value, whose exponent is the bit length (exact below 2^53)."""
    _, e = torch.frexp(x.to(torch.float64))
    return (e - 1).to(LANE)


def floor_log2(x, width: int = 32) -> torch.Tensor:
    """floor(log2(x)) of the unsigned ``width``-bit value in each int64
    lane (-1 for 0): one ``frexp`` up to 53 bits; wider, the high and the
    low 32 bits apart."""
    x = torch.as_tensor(x, dtype=LANE)
    if width <= 53:
        return _floor_log2_53(x)
    hi = (x >> 32) & 0xFFFFFFFF
    return torch.where(hi != 0, 32 + _floor_log2_53(hi),
                       _floor_log2_53(x & 0xFFFFFFFF))


def clz(x, width: int) -> torch.Tensor:
    """Leading zeros of the low ``width`` bits of x (x < 2**width)."""
    x = torch.as_tensor(x, dtype=LANE)
    return width - 1 - floor_log2(x, width)


def bit(x, i, width: int = 32) -> torch.Tensor:
    """Bit ``i`` (0 = LSB) of x, 0 for ``i >= width``."""
    return safe_shr(x, i, width) & 1
