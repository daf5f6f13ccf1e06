"""Elementwise takum codec: the CUDA kernels of ``csrc/codec.cu``.

Replaces ``repro/kernels/takum_codec.py::decode_kernel_call`` and
``::encode_kernel_call``, for linear takum (``takum8``/``takum16``),
logarithmic takum (``lns-takum8``/``lns-takum16``) and posit
(``posit8``/``posit16``; posit8 decodes through its shared-memory table
when ``spec.lut_decode``). Bound by bytes on the H100 (words plus f32 per
element); see the source's header comment for the design.

``decode``/``encode`` launch the kernel for CUDA tensors and run the
plain torch codec (``ref.decode_ref``/``ref.encode_ref``) for CPU
tensors; each keeps a plain-integer launch counter, ``fn.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.formats import FormatSpec
from repro_torch.kernels import build
from repro_torch.kernels import ref as kref

__all__ = ["decode", "encode"]

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "takum_decode": [_I, _I, _P, _P, _LL, _P],
    "takum_encode": [_I, _I, _P, _P, _LL, _P],
}


def _lib():
    return build.library("codec", _SIGNATURES)


def decode(words: torch.Tensor, spec: FormatSpec) -> torch.Tensor:
    """Wire words (any shape, ``spec.word_dtype``) -> float32."""
    if not words.is_cuda:
        return kref.decode_ref(words, spec)
    code = build.format_code(spec, words.device)
    _check_words(words, spec)
    words = words.contiguous()
    out = torch.empty(words.shape, dtype=torch.float32, device=words.device)
    err = _lib().takum_decode(spec.n, code, words.data_ptr(), out.data_ptr(),
                              words.numel(), build.stream_of(words))
    build.check(err, "takum_decode")
    build.launched(decode, code)
    return out


def encode(x: torch.Tensor, spec: FormatSpec) -> torch.Tensor:
    """float32 (any shape; other float dtypes are cast) -> wire words."""
    if not x.is_cuda:
        return kref.encode_ref(x, spec)
    code = build.format_code(spec, x.device)
    x = x.to(torch.float32).contiguous()
    out = torch.empty(x.shape, dtype=spec.word_dtype, device=x.device)
    err = _lib().takum_encode(spec.n, code, x.data_ptr(), out.data_ptr(),
                              x.numel(), build.stream_of(x))
    build.check(err, "takum_encode")
    encode.launches += 1
    return out


def _check_words(words: torch.Tensor, spec: FormatSpec) -> None:
    if words.dtype != spec.word_dtype:
        raise TypeError(f"{spec.name} words must be {spec.word_dtype}, "
                        f"got {words.dtype}")


decode.launches = 0
encode.launches = 0
