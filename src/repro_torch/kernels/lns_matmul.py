"""LNS matmul on the ell_bar datapath: the CUDA kernel of
``csrc/lns_matmul.cu``.

Replaces ``repro/kernels/lns_matmul.py::lns_matmul_kernel_call``.
Products are int32 adds of the operands' ``ell`` lanes; ``accum="linear"``
converts each with one ``expf`` and sums in f32 (bound by the SFU on the
H100), ``accum="gauss"`` folds them in order through the Gauss-log table
and converts once (bound by the integer fold). See the source's header
comment for the design.

``lns_matmul`` launches the kernel for CUDA tensors and runs
``ref.lns_matmul_plain`` for CPU tensors; ``lns_matmul.launches`` counts
launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.core import lns
from repro_torch.core.takum import frac_width
from repro_torch.formats import FormatSpec
from repro_torch.kernels import build
from repro_torch.kernels import ref as kref

__all__ = ["lns_matmul", "launch_plan", "LINEAR_BLOCKS"]

SMS = 132         # H100 SXM streaming multiprocessors
# linear variants: (rows, columns, K tile) of a block; see the source
LINEAR_BLOCKS = {0: (4, 128, 32), 1: (64, 64, 16)}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"takum_lns_matmul": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _P]}
_LUTS: Dict[Tuple[int, str], torch.Tensor] = {}


def launch_plan(m: int, k: int, n: int, accum: str = "linear"):
    """(variant, split, K tiles per split) for an [m, k] x [k, n] call.

    Gauss: one block shape, never split (the fold runs k = 0..K-1 in
    order). Linear, on the tiled skeleton (``csrc/tiled_matmul.cuh``):
    variant 0 when its block (``LINEAR_BLOCKS``) holds all m rows (decode
    batches: every weight word decoded once), else variant 1 (prefill
    chunks); K is split across blocks when the (N, M) grid would leave
    the SMs idle."""
    if accum == "gauss":
        return 0, 1, 1
    variant = 0 if m <= LINEAR_BLOCKS[0][0] else 1
    bm, bn, bk = LINEAR_BLOCKS[variant]
    kt = max(1, -(-k // bk))
    grid = -(-n // bn) * -(-m // bm)
    split = 1
    if grid < 2 * SMS:
        split = max(1, min(-(-2 * SMS // grid), kt // 8))
    per = -(-kt // split)
    return variant, -(-kt // per), per


def _lut(wf: int, device) -> torch.Tensor:
    key = (wf, str(device))
    if key not in _LUTS:
        _LUTS[key] = lns.gauss_tables(wf, device=device).contiguous()
    return _LUTS[key]


def lns_matmul(x_words: torch.Tensor, w_words: torch.Tensor,
               spec: FormatSpec, accum: str = "linear", *,
               state: bool = False):
    """decode(x_words [M, K]) (x) decode(w_words [K, N]) -> f32 [M, N].

    Both operands are ``spec``'s LNS words. With ``state=True`` (gauss
    only) also returns the final integer state ``(ell, flags)``, int32
    [M, N] each (flags = S | zero << 1 | NaR << 2)."""
    if not x_words.is_cuda:
        return kref.lns_matmul_plain(x_words, w_words, spec, accum,
                                     state=state)
    if accum not in ("linear", "gauss"):
        raise ValueError(f"unknown accum {accum!r}")
    if state and accum != "gauss":
        raise ValueError("state=True returns the gauss accumulator's state")
    if not spec.has_lns_parts or spec.n not in (8, 16):
        raise TypeError(f"lns_matmul takes lns-takum8/16 words, got "
                        f"{spec.name!r}")
    for t in (x_words, w_words):
        if t.dtype != spec.word_dtype or t.ndim != 2:
            raise TypeError(f"lns_matmul takes 2D {spec.word_dtype} words, "
                            f"got {t.dtype} {tuple(t.shape)}")
    m, k = x_words.shape
    k2, n = w_words.shape
    if k != k2:
        raise ValueError(f"lns_matmul: x {tuple(x_words.shape)} (x) w "
                         f"{tuple(w_words.shape)}")
    dev = x_words.device
    if not w_words.is_cuda or w_words.device != dev:
        raise ValueError("x_words and w_words must be on the same CUDA "
                         "device")
    x_words, w_words = x_words.contiguous(), w_words.contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    variant, split, per = launch_plan(m, k, n, accum)
    gauss = accum == "gauss"
    work = (torch.empty((split, m, n), dtype=torch.float32, device=dev)
            if split > 1 else out)
    lut = _lut(frac_width(spec.n), dev) if gauss else None
    ell = flags = None
    if state:
        ell = torch.empty((m, n), dtype=torch.int32, device=dev)
        flags = torch.empty_like(ell)
    err = _lib().takum_lns_matmul(
        spec.n, int(gauss), variant, x_words.data_ptr(), w_words.data_ptr(),
        None if lut is None else lut.data_ptr(), out.data_ptr(),
        work.data_ptr(), None if ell is None else ell.data_ptr(),
        None if flags is None else flags.data_ptr(), m, k, n, split, per,
        build.stream_of(x_words))
    build.check(err, "takum_lns_matmul")
    lns_matmul.launches += 1
    return (out, ell, flags) if state else out


def _lib():
    return build.library("lns_matmul", _SIGNATURES)


lns_matmul.launches = 0
