"""Wire-weight matmul: the CUDA kernel of ``csrc/qmatmul.cu``.

Replaces ``repro/kernels/takum_matmul.py::qmatmul_kernel_call``, for
takum8/16 and posit8/16 weight words (posit8 through the shared-memory
table when ``spec.lut_decode``). Bound by the weight words' bytes at
decode batch sizes and by f32 FMAs at prefill chunks; see the source's
header comment for the design.

``qmatmul`` launches the kernel for CUDA tensors (ragged M, K and N are
masked in the kernel) and runs ``ref.qmatmul_ref`` for CPU tensors;
``qmatmul.launches`` counts launches. :func:`launch_plan` also plans the
linear LNS matmul, which shares the kernel's tiled skeleton
(``csrc/tiled_matmul.cuh``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.formats import FormatSpec
from repro_torch.kernels import build
from repro_torch.kernels import ref as kref

__all__ = ["qmatmul", "BLOCKS", "launch_plan"]

SMS = 132         # H100 SXM streaming multiprocessors
# (rows, columns, K tile) of a block, per variant of csrc/qmatmul.cu
BLOCKS = {0: (16, 64, 64), 1: (64, 64, 16)}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"takum_qmatmul": [_I, _I, _I, _P, _P, _P, _P, _I, _I, _I,
                                 _I, _I, _P]}


def launch_plan(m: int, k: int, n: int, blocks=BLOCKS):
    """(variant, split, K tiles per split) for an [m, k] x [k, n] call of
    a kernel on the tiled skeleton whose variants have ``blocks``.

    Variant 0 when its block holds all m rows (decode batches: every
    weight word decoded once), else variant 1 (prefill chunks). K is
    split across blocks when the (N, M) grid would leave the SMs idle."""
    variant = 0 if m <= blocks[0][0] else 1
    bm, bn, bk = blocks[variant]
    kt = max(1, -(-k // bk))
    grid = -(-n // bn) * -(-m // bm)
    split = 1
    if grid < 2 * SMS:
        split = max(1, min(-(-2 * SMS // grid), kt // 8))
    per = -(-kt // split)
    return variant, -(-kt // per), per


def qmatmul(x: torch.Tensor, w_words: torch.Tensor,
            spec: FormatSpec) -> torch.Tensor:
    """x [M, K] float @ decode(w_words [K, N]) -> f32 [M, N]."""
    if not x.is_cuda:
        return kref.qmatmul_ref(x, w_words, spec)
    m, k = x.shape
    k2, n = w_words.shape
    if k != k2:
        raise ValueError(f"qmatmul: x {tuple(x.shape)} @ w "
                         f"{tuple(w_words.shape)}")
    if (spec.kind not in ("linear", "posit") or spec.n not in (8, 16)
            or w_words.dtype != spec.word_dtype):
        raise TypeError(f"qmatmul takes takum8/16 or posit8/16 words, got "
                        f"{spec.name} {w_words.dtype}")
    if not w_words.is_cuda or w_words.device != x.device:
        raise ValueError("x and w_words must be on the same CUDA device")
    code = build.format_code(spec, x.device, kinds=("linear", "posit"))
    x = x.to(torch.float32).contiguous()
    w_words = w_words.contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    variant, split, per = launch_plan(m, k, n)
    work = (torch.empty((split, m, n), dtype=torch.float32, device=x.device)
            if split > 1 else out)
    err = _lib().takum_qmatmul(spec.n, code, variant, x.data_ptr(),
                               w_words.data_ptr(), out.data_ptr(),
                               work.data_ptr(), m, k, n, split, per,
                               build.stream_of(x))
    build.check(err, "takum_qmatmul")
    build.launched(qmatmul, code)
    return out


def _lib():
    return build.library("qmatmul", _SIGNATURES)


qmatmul.launches = 0
