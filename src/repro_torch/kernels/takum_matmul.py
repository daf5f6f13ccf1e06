"""Wire-weight matmul: the CUDA kernels of ``csrc/qmatmul.cu``.

Replaces ``repro/kernels/takum_matmul.py::qmatmul_kernel_call``, for
takum8/16 and posit8/16 weight words (posit8 through the shared-memory
table when ``spec.lut_decode``; takum8 always through its own table).
Two regimes, chosen per call by :func:`launch_plan`: decode batches
(M <= 16) stream the weight words, bound by their bytes; prefill chunks
run split TF32 products on the tensor cores, bound by the products. See
the source's header comment for the designs.

``qmatmul`` launches a kernel for CUDA tensors (ragged M, K and N are
masked in the kernels) and runs ``ref.qmatmul_ref`` for CPU tensors;
``qmatmul.launches`` counts calls that launched (one per call, whatever
the regime and however K is split). Without an explicit ``plan`` a call
takes ``autotune.resolved_plan`` (the tuned table's entry for its shape
bucket, else :func:`launch_plan`). Fake tensors (the dry run's) take the
fake branch (``kernels/cost.py``): the output's shape, no launch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.formats import FormatSpec
from repro_torch.kernels import autotune, build, cost
from repro_torch.kernels import ref as kref

__all__ = ["qmatmul", "launch_plan", "STREAM_M", "KTILE", "STREAM_BLOCKS",
           "TC_BLOCKS"]

SMS = 132         # H100 SXM streaming multiprocessors
STREAM_M = 16     # largest M of the streaming kernel (variant 0)
KTILE = 32        # rows of K in a tile, both variants
# streaming kernel, by word bits: (rows of x, columns) of a block
STREAM_BLOCKS = {8: (4, 512), 16: (8, 256)}
STREAM_X_FLOATS = 8192    # x a streaming block stages in shared memory
# tensor-core kernel, by word bits: (rows, columns) of a block; 16-bit
# words share each computed decode between 128 rows
TC_BLOCKS = {8: (64, 128), 16: (128, 128)}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"takum_qmatmul": [_I, _I, _I, _P, _P, _P, _P, _I, _I, _I,
                                 _I, _I, _P]}


def launch_plan(m: int, k: int, n: int, bits: int = 8):
    """(variant, split, K tiles per split) for an [m, k] x [k, n] call
    with ``bits``-bit weight words; K tiles are ``KTILE`` rows.

    Variant 0 (m <= ``STREAM_M``, decode batches) streams the weights:
    K is split across blocks until about 4 blocks per SM are busy, but
    never into more partial sums (split * m * n floats) than a quarter of
    the weight bytes, and a block's x slice fits its stage. Variant 1
    (prefill chunks, the tensor cores) splits K only when the (N, M) grid
    would leave the SMs idle."""
    kt = max(1, -(-k // KTILE))
    if m <= STREAM_M:
        mc, bn = STREAM_BLOCKS[bits]
        grid = -(-n // bn) * -(-m // mc)
        cap = max(1, k * bits // (128 * m))
        split = max(1, min(kt, -(-4 * SMS // grid), cap))
        per = min(-(-kt // split), STREAM_X_FLOATS // (mc * KTILE))
        return 0, -(-kt // per), per
    bm, bn = TC_BLOCKS[bits]
    grid = -(-n // bn) * -(-m // bm)
    split = 1
    if grid < 2 * SMS:
        split = max(1, min(-(-2 * SMS // grid), kt // 8))
    per = -(-kt // split)
    return 1, -(-kt // per), per


def qmatmul(x: torch.Tensor, w_words: torch.Tensor,
            spec: FormatSpec, *, plan=None) -> torch.Tensor:
    """x [M, K] float @ decode(w_words [K, N]) -> f32 [M, N]; ``plan``
    (variant, split, K tiles per split) overrides the resolved one."""
    if not cost.on_card(x):
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
    if not cost.on_card(w_words) or w_words.device != x.device:
        raise ValueError("x and w_words must be on the same CUDA device")
    code = build.format_code(spec, x.device, kinds=("linear", "posit"))
    if cost.is_fake(x):
        out = torch.empty((m, n), dtype=torch.float32, device=x.device)
        cost.charge("qmatmul", 2 * m * k * n, cost.nbytes(x)
                    + cost.nbytes(w_words) + cost.nbytes(out))
        return out
    x = x.to(torch.float32).contiguous()
    w_words = w_words.contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    variant, split, per = (plan if plan is not None else
                           autotune.resolved_plan("qmatmul", spec,
                                                  (m, k, n)))
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
