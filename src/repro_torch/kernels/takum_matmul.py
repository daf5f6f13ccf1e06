"""Wire-weight matmul: the CUDA kernel of ``csrc/qmatmul.cu``.

Replaces ``repro/kernels/takum_matmul.py::qmatmul_kernel_call``. Bound
by the weight words' bytes at decode batch sizes and by f32 FMAs at
prefill chunks; see the source's header comment for the design.

``qmatmul`` launches the kernel for CUDA tensors (padding ``K`` and ``N``
with zero words to the kernel's multiple of 64: zero words decode to
0.0, so the padding is exact) and runs ``ref.qmatmul_ref`` for CPU
tensors; ``qmatmul.launches`` counts launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core.bitops import carrier
from repro_torch.formats import FormatSpec
from repro_torch.kernels import build
from repro_torch.kernels import ref as kref

__all__ = ["qmatmul", "PAD", "launch_plan"]

PAD = 64          # K and N multiple the kernel takes
SMS = 132         # H100 SXM streaming multiprocessors
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"takum_qmatmul": [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _I, _P]}


def launch_plan(m: int, k: int, n: int):
    """(variant, split, k-tiles per split) for an [m, k] @ [k, n] call.

    Variant 0 holds up to 16 rows per block (decode batches: every weight
    word decoded once), variant 1 64 rows (prefill chunks). K is split
    across blocks when the (N, M) grid would leave the SMs idle."""
    variant, bm, bk = (0, 16, 64) if m <= 16 else (1, 64, 16)
    kt = k // bk
    blocks = (n // 64) * -(-m // bm)
    split = 1
    if blocks < 2 * SMS:
        split = max(1, min(-(-2 * SMS // blocks), kt // 8))
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
    if spec.is_identity or spec.n not in (8, 16) or w_words.dtype != spec.word_dtype:
        raise TypeError(f"qmatmul takes takum8/takum16 words, got {spec.name} "
                        f"{w_words.dtype}")
    if not w_words.is_cuda or w_words.device != x.device:
        raise ValueError("x and w_words must be on the same CUDA device")
    pk, pn = -k % PAD, -n % PAD
    x = x.to(torch.float32)
    if pk:
        x = F.pad(x, (0, pk))
    if pk or pn:
        w_words = F.pad(carrier(w_words), (0, pn, 0, pk)).view(w_words.dtype)
    x, w_words = x.contiguous(), w_words.contiguous()
    kp, np_ = k + pk, n + pn
    out = torch.empty((m, np_), dtype=torch.float32, device=x.device)
    variant, split, per = launch_plan(m, kp, np_)
    work = (torch.empty((split, m, np_), dtype=torch.float32, device=x.device)
            if split > 1 else out)
    err = _lib().takum_qmatmul(spec.n, variant, x.data_ptr(),
                               w_words.data_ptr(), out.data_ptr(),
                               work.data_ptr(), m, kp, np_, split, per,
                               build.stream_of(x))
    build.check(err, "takum_qmatmul")
    qmatmul.launches += 1
    return out[:, :n] if pn else out


def _lib():
    return build.library("qmatmul", _SIGNATURES)


qmatmul.launches = 0
