"""Barred-ell_bar LNS arithmetic on logarithmic takums (section III).

A logarithmic takum is ``(S, ell_bar)`` with ``ell_bar = (-1)^S ell`` a
signed fixed-point number of ``frac_width(n)`` fraction bits; the value is
``(-1)^S sqrt(e)^ell``. A product is one add of ``ell`` lanes (exact); a
sum needs the Gauss-log functions ``phi(d) = 2 ln(1 +- e^(d/2))``:
evaluated in f32 by ``add``, and as a fixed-point look-up table with
linear interpolation where the LNS matmul folds products
(``accum="gauss"``).

* ``LnsTensor`` carries ``(s, ell_bar, is_zero, is_nar)``;
  ``from_words``/``to_words`` convert from and to n-bit words; ell_bar
  lives in an int64 lane, so the arithmetic takes n <= 60 (wf <= 55)
  and refuses wider words with OverflowError, where the reference's
  int64 saturation limit ``255 << wf`` overflows (n >= 61);
  ``mul``/``div``/``sqrt`` are exact (an add, a subtract, an arithmetic
  shift of ``ell``, saturated to the dynamic range); ``add`` evaluates
  ``phi`` in f32 and rounds it to the ``ell`` grid, at every width to
  n = 60.

* ``gauss_tables`` builds the ``(2, 1024)`` int32 table in numpy float64
  and rounds it once, so it is the same table bit for bit wherever it is
  built (the CUDA kernel receives it from here).
* ``gauss_add_parts`` is one fold on ``(s, ell, zero)`` integer lanes:
  order the operands, one table gather and interpolation, one add, one
  clip. Integer-only, so every implementation agrees bit for bit.
* ``lns_matmul`` is the demo-scale reference (an ``[M, K, N]`` grid of
  products, converted and summed linearly).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import takum
from repro_torch.core.takum import frac_width

__all__ = ["LnsTensor", "from_words", "to_words", "mul", "div", "sqrt",
           "add", "gauss_tables", "gauss_add_parts", "lns_matmul",
           "GAUSS_LUT_SIZE", "GAUSS_STEP_LOG2", "ELL_MAX_INT"]

ELL_MAX_INT = 255      # |ell_bar| < 255 by construction
_BELOW_ONE = float(np.float32(1.0 - 1e-7))   # the f32 cap of e^(d/2)
GAUSS_STEP_LOG2 = -6   # table step in ell units: 2^-6 per entry
GAUSS_LUT_SIZE = 1024  # covers d in (-(SIZE-1) * 2^STEP_LOG2, 0] ~ (-16, 0]


class LnsTensor(NamedTuple):
    s: torch.Tensor        # sign, int64 0/1
    ell_bar: torch.Tensor  # signed fixed point, wf fraction bits (int64)
    is_zero: torch.Tensor
    is_nar: torch.Tensor


def _check_wf(wf: int) -> None:
    if wf > 55:
        raise OverflowError(f"LNS arithmetic holds ell_bar in int64 lanes: "
                            f"wf <= 55 (n <= 60), got wf={wf} (the "
                            "reference: Python int too large to convert "
                            "to C long)")


def from_words(words, n: int) -> LnsTensor:
    _check_wf(frac_width(n))
    d = takum.decode_lns(words, n)
    return LnsTensor(d.s, d.ell_bar, d.is_zero, d.is_nar)


def to_words(t: LnsTensor, n: int, *, wf: int) -> torch.Tensor:
    return takum.encode_lns(t.s, t.ell_bar, n, wf=wf, is_zero=t.is_zero,
                            is_nar=t.is_nar)


def _ell(t: LnsTensor) -> torch.Tensor:
    """The un-barred ``ell = (-1)^S ell_bar``."""
    return torch.where(t.s == 1, -t.ell_bar, t.ell_bar)


def _rebar(s, ell, is_zero, is_nar, wf: int) -> LnsTensor:
    """Saturate ``ell`` to the dynamic range and bar it again."""
    _check_wf(wf)
    lim = ELL_MAX_INT << wf
    ell = torch.clamp(ell, -lim, lim)
    return LnsTensor(s, torch.where(s == 1, -ell, ell), is_zero, is_nar)


def mul(a: LnsTensor, b: LnsTensor, *, wf: int) -> LnsTensor:
    """Exact: ``ell_a + ell_b``, the sign an XOR."""
    is_nar = a.is_nar | b.is_nar
    return _rebar(a.s ^ b.s, _ell(a) + _ell(b),
                  (a.is_zero | b.is_zero) & ~is_nar, is_nar, wf)


def div(a: LnsTensor, b: LnsTensor, *, wf: int) -> LnsTensor:
    """Exact: ``ell_a - ell_b``; x / 0 is NaR (takum semantics)."""
    is_nar = a.is_nar | b.is_nar | b.is_zero
    return _rebar(a.s ^ b.s, _ell(a) - _ell(b), a.is_zero & ~is_nar,
                  is_nar, wf)


def sqrt(a: LnsTensor, *, wf: int) -> LnsTensor:
    """Exact: an arithmetic right shift of ``ell``; the root of a negative
    value is NaR."""
    is_nar = a.is_nar | ((a.s == 1) & ~a.is_zero)
    return _rebar(torch.zeros_like(a.s), _ell(a) >> 1, a.is_zero & ~is_nar,
                  is_nar, wf)


def add(a: LnsTensor, b: LnsTensor, *, wf: int) -> LnsTensor:
    """Gauss-log addition ``a + b = sqrt(e)^ell_a (1 +- sqrt(e)^d)``, the
    software stand-in for the hardware table and interpolator: ``phi(d) =
    2 ln(1 +- e^(d/2))`` evaluated in f32 and rounded to the ``wf``-bit
    grid (error at most the f32 evaluation's plus half a grid step). A
    zero operand returns the other; opposite signs of equal magnitude
    cancel to zero; NaR is sticky."""
    ea, eb = _ell(a), _ell(b)
    a_ge = ea >= eb                      # the larger is the base; d <= 0
    base_ell = torch.where(a_ge, ea, eb)
    base_s = torch.where(a_ge, a.s, b.s)
    same = base_s == torch.where(a_ge, b.s, a.s)
    d = (torch.minimum(ea, eb) - base_ell).to(torch.float32) / (1 << wf)
    expd = torch.exp(d * 0.5)
    # 2 ln(1 - e^(d/2)) diverges at d = 0: e^(d/2) is capped below 1
    phi = torch.where(same, 2.0 * torch.log1p(expd),
                      2.0 * torch.log1p(-torch.clamp(expd, max=_BELOW_ONE)))
    ell = base_ell + torch.round(phi * (1 << wf)).to(base_ell.dtype)
    cancel = ~same & (d == 0.0)
    ell = torch.where(a.is_zero, eb, torch.where(b.is_zero, ea, ell))
    s = torch.where(a.is_zero, b.s, torch.where(b.is_zero, a.s, base_s))
    is_zero = (a.is_zero & b.is_zero) | (cancel & ~a.is_zero & ~b.is_zero)
    is_nar = a.is_nar | b.is_nar
    return _rebar(s, ell, is_zero & ~is_nar, is_nar, wf)


def gauss_tables(wf: int, *, size: int = GAUSS_LUT_SIZE,
                 step_log2: int = GAUSS_STEP_LOG2,
                 device=None) -> torch.Tensor:
    """The quantised Gauss-log tables, int32 ``(2, size)``: row 0 is
    ``phi_add(d) = 2 ln(1 + e^(d/2))``, row 1 ``phi_sub(d) = 2 ln(1 -
    e^(d/2))``, sampled at ``d = -i * 2^step_log2`` and rounded to ``wf``
    fraction bits. ``phi_sub`` is floored at ``-2 * 255`` (it diverges at
    d = 0; exact cancellation is handled outside the table).
    ``wf <= 18`` keeps the entries and the interpolation in int32."""
    if wf > 18:
        raise ValueError(f"gauss tables overflow int32 lanes for wf={wf} "
                         "(need wf <= 18, i.e. n <= 23)")
    d = -np.arange(size, dtype=np.float64) * 2.0 ** step_log2
    ed = np.exp(d * 0.5)
    phi_add = 2.0 * np.log1p(ed)
    with np.errstate(divide="ignore"):
        phi_sub = 2.0 * np.log(np.maximum(1.0 - ed, 1e-300))
    phi_sub = np.maximum(phi_sub, -2.0 * ELL_MAX_INT)
    tab = np.round(np.stack([phi_add, phi_sub]) * (1 << wf)).astype(np.int32)
    return torch.from_numpy(tab).to(device)


def gauss_add_parts(s_a, ell_a, zero_a, s_b, ell_b, zero_b, lut, *,
                    wf: int, step_log2: int = GAUSS_STEP_LOG2):
    """One Gauss-log fold ``a + b`` on ``(s, ell, zero)`` integer lanes
    (un-barred ``ell``, ``wf`` fraction bits, ``zero`` 0/1) through a
    :func:`gauss_tables` table. Returns int32 ``(s, ell, zero)``.

    Operands are ordered so that ``d = smaller ell - larger ell <= 0``;
    ``phi`` is the table entry at ``d`` plus a linear interpolation to the
    next one (none across the saturated ``phi_sub(0)`` entry); beyond the
    table the correction is below one ulp and the result is the larger
    operand; opposite signs with ``d = 0`` cancel to zero; a zero operand
    returns the other. The interpolation runs in int64 lanes: it equals
    the int32 arithmetic of the other implementations wherever its result
    is used."""
    step_shift = wf + step_log2
    if step_shift < 0:
        raise ValueError(f"wf={wf} finer than the LUT step")
    size = lut.shape[-1]
    i64 = torch.int64
    s_a, ell_a, zero_a = s_a.to(i64), ell_a.to(i64), zero_a.to(i64)
    s_b, ell_b, zero_b = s_b.to(i64), ell_b.to(i64), zero_b.to(i64)
    a_ge = ell_a >= ell_b
    base_s = torch.where(a_ge, s_a, s_b)
    other_s = torch.where(a_ge, s_b, s_a)
    base = torch.maximum(ell_a, ell_b)
    nd = base - torch.minimum(ell_a, ell_b)       # -d >= 0, in 2^-wf ulps
    same = base_s == other_s
    idx = torch.clamp(nd >> step_shift, max=size - 2)
    in_range = nd < ((size - 1) << step_shift)
    rem = nd - (idx << step_shift)
    flat = torch.where(same, 0, size) + idx
    table = lut.reshape(-1).to(device=flat.device, dtype=i64)
    lo = table[flat]
    hi = table[flat + 1]
    slope = torch.where(~same & (idx == 0), 0, hi - lo)
    phi = lo + ((rem * slope) >> step_shift)
    phi = torch.where(in_range, phi, 0)
    lim = ELL_MAX_INT << wf
    ell = torch.clamp(base + phi, -lim, lim)
    cancel = ~same & (nd == 0)
    ell = torch.where(zero_a == 1, ell_b, torch.where(zero_b == 1, ell_a, ell))
    s = torch.where(zero_a == 1, s_b, torch.where(zero_b == 1, s_a, base_s))
    zero = torch.where((zero_a == 1) & (zero_b == 1), 1,
                       torch.where((zero_a == 1) | (zero_b == 1), 0,
                                   cancel.to(i64)))
    i32 = torch.int32
    return s.to(i32), ell.to(i32), zero.to(i32)


def lns_matmul(x_words, w_words, n: int, *,
               accum_dtype=torch.float32) -> torch.Tensor:
    """Demo-scale LNS matmul: products as ``ell`` adds on an ``[M, K, N]``
    grid, each converted once (``sqrt(e)^ell``), summed over K in
    ``accum_dtype``. NaR words are not treated specially here."""
    xd = takum.decode_lns(x_words, n)
    wd = takum.decode_lns(w_words, n)
    wf = frac_width(n)
    ellx = torch.where(xd.s == 1, -xd.ell_bar, xd.ell_bar)
    ellw = torch.where(wd.s == 1, -wd.ell_bar, wd.ell_bar)
    ell_p = ellx[:, :, None] + ellw[None, :, :]
    s_p = xd.s[:, :, None] ^ wd.s[None, :, :]
    zero_p = xd.is_zero[:, :, None] | wd.is_zero[None, :, :]
    mag = torch.exp(ell_p.to(accum_dtype) * (0.5 / (1 << wf)))
    prod = torch.where(zero_p, torch.zeros_like(mag),
                       torch.where(s_p == 1, -mag, mag))
    return prod.sum(dim=1)
