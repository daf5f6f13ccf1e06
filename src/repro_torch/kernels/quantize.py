"""Fused fake-quantisation: the CUDA kernel of ``csrc/fake_quant.cu``.

Replaces ``repro/kernels/quantize.py::fake_quant_kernel_call``: a round
trip through a wire format's grid (encode, then decode) in one pass, f32
in and f32, bf16 or f64 out (f64: the word decoded to f64, as the
reference's), for linear takum (scaled by a power of two or not),
logarithmic takum and posit at every width 6 <= n <= 64 (posit8's table
code included, ``spec.lut_decode``). Bound by bytes on the H100 (4 bytes
in, 4, 2 or 8 out per element). Linear takum and posit round in
value space, the float's own bits to nearest even at the word's
fraction width, where the word keeps a fraction bit
(``ref.fake_quant_dataflow`` is the plain mirror); LNS and the rare
vectors take the codec kernels' table encode and decode. See the
source's header comment for the design.

``fake_quant`` launches the kernel for CUDA tensors and runs
``ref.fake_quant_ref`` for CPU tensors; ``fake_quant.launches`` counts
launches. Fake tensors (the dry run's) take the fake branch
(``kernels/cost.py``): the output's shape and dtype, no launch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quant import exp2i
from repro_torch.formats import FormatSpec
from repro_torch.kernels import build, cost
from repro_torch.kernels import ref as kref

__all__ = ["fake_quant"]

OUT_DTYPES = (torch.float32, torch.bfloat16, torch.float64)
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
_SIGNATURES = {"takum_fake_quant": [_I, _I, _I, _P, _P, _LL, _I, _F, _F,
                                    _P]}


def _lib():
    return build.library("fake_quant", _SIGNATURES)


def fake_quant(x: torch.Tensor, spec: FormatSpec, *, dtype=torch.float32,
               scale_exp: int = 0) -> torch.Tensor:
    """decode(encode(x * 2^k)) * 2^-k in ``dtype`` (f32, bf16 or f64),
    any shape; ``x`` of another float dtype is cast to f32 first; k =
    ``scale_exp`` (0: the unscaled round trip; linear takum only, the
    other kinds round trip unscaled)."""
    if dtype not in OUT_DTYPES:
        raise TypeError(f"fake_quant writes float32, bfloat16 or float64, "
                        f"got {dtype}")
    if not -127 <= scale_exp <= 127:
        raise ValueError(f"scale_exp {scale_exp} outside [-127, 127]")
    if scale_exp and spec.kind != "linear":
        raise ValueError(f"{spec.name} fake-quantises unscaled")
    if not cost.on_card(x):
        return kref.fake_quant_ref(x, spec, dtype=dtype, scale_exp=scale_exp)
    code = build.format_code(spec, x.device,
                             widths=build.CODEC_WIDTHS)
    if cost.is_fake(x):
        out = torch.empty(x.shape, dtype=dtype, device=x.device)
        cost.charge("fake_quant", 0, cost.nbytes(x) + cost.nbytes(out))
        return out
    if dtype == torch.float64 and code == build.POSIT8_LUT:
        code = build.KIND_CODES["posit"]   # the table holds float32s
    x = x.to(torch.float32).contiguous()
    out = torch.empty(x.shape, dtype=dtype, device=x.device)
    err = _lib().takum_fake_quant(
        spec.n, code, int(scale_exp != 0), x.data_ptr(), out.data_ptr(),
        x.numel(), _OUT_CODES[dtype], float(exp2i(scale_exp)),
        float(exp2i(-scale_exp)), build.stream_of(x))
    build.check(err, "takum_fake_quant")
    build.launched(fake_quant, code)
    return out


fake_quant.launches = 0
