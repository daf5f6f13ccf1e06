"""LNS matmul on the ell_bar datapath: the CUDA kernels of
``csrc/lns_matmul.cu``.

Replaces ``repro/kernels/lns_matmul.py::lns_matmul_kernel_call``.
Products are int32 adds of the operands' ``ell`` lanes; ``accum="linear"``
converts each with one ``expf`` and sums in f32 (bound by instruction
issue around the SFU's ``expf`` on the H100), ``accum="gauss"`` folds them
in order through the Gauss-log table and converts once (bound by the
integer fold). Linear accumulation runs in two regimes, chosen per call by
:func:`launch_plan`: decode batches (M <= ``STREAM_M``) stream the weight
words through column-strip blocks, prefill chunks run register-blocked
tiles. See the source's header comment for the designs.

``lns_matmul`` launches the kernel for CUDA tensors and runs
``ref.lns_matmul_plain`` for CPU tensors; ``lns_matmul.launches`` counts
calls that launched (one per call, however K is split), and
``lns_matmul.split_launches`` those that also summed K splits in a second
launch. Without an explicit ``plan`` a linear call takes
``autotune.resolved_plan`` (the tuned table's entry for its shape
bucket, else :func:`launch_plan`); gauss always takes its one plan. Fake
tensors (the dry run's) take the fake branch (``kernels/cost.py``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.core import lns
from repro_torch.core.takum import frac_width
from repro_torch.formats import FormatSpec
from repro_torch.kernels import autotune, build, cost
from repro_torch.kernels import ref as kref

__all__ = ["lns_matmul", "launch_plan", "STREAM_M", "KTILE",
           "STREAM_BLOCK", "TILE_BLOCK"]

SMS = 132         # H100 SXM streaming multiprocessors
STREAM_M = 16     # largest M of the streaming kernel (variant 0)
# rows of K in a tile, by variant (0: streaming, 1: register tiles)
KTILE = {0: 128, 1: 16}
STREAM_BLOCK = 4           # rows of x of a streaming block
TILE_BLOCK = (64, 64)      # (rows, columns) of a register-tile block
# K is split until about this many blocks an SM are queued (streaming,
# register tiles): see launch_plan. The register tiles take many small
# splits, which even out the SMs' last wave (on an H100, 24 beat 6 and 12
# at the prefill shapes: tools/torch_kernel_times.py --variants)
STREAM_PER_SM, TILE_PER_SM = 4, 24
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"takum_lns_matmul": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _P]}
_LUTS: Dict[Tuple[int, str], torch.Tensor] = {}


def launch_plan(m: int, k: int, n: int, accum: str = "linear",
                bits: int = 8):
    """(variant, split, K tiles per split) for an [m, k] x [k, n] call
    with ``bits``-bit words; K tiles are ``KTILE[variant]`` rows.

    Gauss: one block shape, never split (the fold runs k = 0..K-1 in
    order). Linear: m <= ``STREAM_M`` (decode batches) streams the
    weights (variant 0: ``STREAM_BLOCK`` rows of x a block, two 16-byte
    weight loads wide, the grid's y over the rows); K is split across
    blocks only where
    the column strips alone would leave the SMs idle (fewer than
    ``STREAM_PER_SM`` blocks an SM). Prefill chunks take variant 1
    (``TILE_BLOCK`` tiles), K split until about ``TILE_PER_SM`` blocks an
    SM are queued, each split at least 8 tiles."""
    if accum == "gauss":
        return 0, 1, 1
    if m <= STREAM_M:
        variant = 0
        mc, bn = STREAM_BLOCK, 2 * 128 // bits
        target, least = STREAM_PER_SM * SMS, 1
    else:
        variant = 1
        mc, bn = TILE_BLOCK
        target, least = TILE_PER_SM * SMS, 8
    kt = max(1, -(-k // KTILE[variant]))
    grid = -(-n // bn) * -(-m // mc)
    split = 1
    if grid < target:
        split = max(1, min(-(-target // grid), kt // least))
    per = -(-kt // split)
    return variant, -(-kt // per), per


def _lut(wf: int, device) -> torch.Tensor:
    key = (wf, str(device))
    if key not in _LUTS:
        _LUTS[key] = lns.gauss_tables(wf, device=device).contiguous()
    return _LUTS[key]


def lns_matmul(x_words: torch.Tensor, w_words: torch.Tensor,
               spec: FormatSpec, accum: str = "linear", *,
               state: bool = False, plan=None):
    """decode(x_words [M, K]) (x) decode(w_words [K, N]) -> f32 [M, N].

    Both operands are ``spec``'s LNS words. With ``state=True`` (gauss
    only) also returns the final integer state ``(ell, flags)``, int32
    [M, N] each (flags = S | zero << 1 | NaR << 2). ``plan`` (variant,
    split, K tiles per split) overrides the resolved one."""
    if not cost.on_card(x_words):
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
    if not cost.on_card(w_words) or w_words.device != dev:
        raise ValueError("x_words and w_words must be on the same CUDA "
                         "device")
    gauss = accum == "gauss"
    if cost.is_fake(x_words):
        out = torch.empty((m, n), dtype=torch.float32, device=dev)
        cost.charge("lns_matmul", 2 * m * k * n, cost.nbytes(x_words)
                    + cost.nbytes(w_words) + cost.nbytes(out))
        if not state:
            return out
        return (out, torch.empty((m, n), dtype=torch.int32, device=dev),
                torch.empty((m, n), dtype=torch.int32, device=dev))
    x_words, w_words = x_words.contiguous(), w_words.contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if plan is not None:
        variant, split, per = plan
    elif gauss:
        variant, split, per = launch_plan(m, k, n, accum, spec.n)
    else:
        variant, split, per = autotune.resolved_plan("lns_qmatmul", spec,
                                                     (m, k, n))
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
    lns_matmul.split_launches += split > 1
    return (out, ell, flags) if state else out


def _lib():
    return build.library("lns_matmul", _SIGNATURES)


lns_matmul.launches = 0
# calls that also launched split_sum_kernel (K split across blocks)
lns_matmul.split_launches = 0
