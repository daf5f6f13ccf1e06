"""Elementwise takum codec: the CUDA kernels of ``csrc/codec.cu``.

Replaces ``repro/kernels/takum_codec.py::decode_kernel_call`` and
``::encode_kernel_call``, for linear takum (``takum<n>``), logarithmic
takum (``lns-takum<n>``) and posit (``posit<n>``; posit8 decodes through
its shared-memory table when ``spec.lut_decode``) at every width
6 <= n <= 64 (``build.CODEC_WIDTHS``; words in uint8, uint16, uint32 or
uint64).
Vectors of 4 elements (16-byte float accesses) over block tables of the
format's headers (``csrc/codec.cuh``); the source's header comment says
what bounds them. The wrappers pass 16-byte aligned tensors
(``build.aligned``: a misaligned view is copied first). ``kv_append``
keeps 8 and 16 bits.

``kv_append`` is the encode of the KV cache: one launch encodes a layer's
fresh K and V and writes the words into a paged pool or a contiguous
cache in place (the reference's ``_encode_kv`` plus its scatter).

``decode`` writes float32 or float64 (other float dtypes are decoded to
float32, then cast, as the reference's); every width decodes to either.

``decode``/``encode``/``kv_append`` launch the kernel for CUDA tensors
and run the plain versions (``ref.decode_ref``/``ref.encode_ref``/
``ref.kv_append_ref``) for CPU tensors; each keeps a plain-integer launch
counter, ``fn.launches``. Fake tensors (the dry run's) take the fake
branch: outputs of the kernel's shapes, its bytes charged to the cost
counter (``kernels/cost.py``), no launch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.formats import FormatSpec
from repro_torch.kernels import build, cost
from repro_torch.kernels import ref as kref

__all__ = ["decode", "encode", "kv_append"]

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "takum_decode": [_I, _I, _I, _P, _P, _LL, _P],
    "takum_encode": [_I, _I, _P, _P, _LL, _P],
    "takum_kv_append": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _I, _I, _I, _I, _P],
}


def _lib():
    return build.library("codec", _SIGNATURES)


def decode(words: torch.Tensor, spec: FormatSpec,
           dtype=torch.float32) -> torch.Tensor:
    """Wire words (any shape, ``spec.word_dtype``) -> ``dtype``: float32
    and float64 written by the kernel, other float dtypes decoded to
    float32, then cast."""
    if not cost.on_card(words):
        return kref.decode_ref(words, spec, dtype=dtype)
    if dtype not in (torch.float32, torch.float64):
        return decode(words, spec).to(dtype)
    code = build.format_code(spec, words.device,
                             widths=build.CODEC_WIDTHS)
    if cost.is_fake(words):
        _check_words(words, spec)
        out = torch.empty(words.shape, dtype=dtype, device=words.device)
        cost.charge("takum_decode", 0, cost.nbytes(words) + cost.nbytes(out))
        return out
    f64 = dtype == torch.float64
    if f64 and code == build.POSIT8_LUT:
        code = build.KIND_CODES["posit"]   # the table holds float32s
    _check_words(words, spec)
    words = build.aligned(words)
    out = torch.empty(words.shape, dtype=dtype, device=words.device)
    err = _lib().takum_decode(spec.n, code, int(f64), words.data_ptr(),
                              out.data_ptr(), words.numel(),
                              build.stream_of(words))
    build.check(err, "takum_decode")
    build.launched(decode, code)
    return out


def encode(x: torch.Tensor, spec: FormatSpec) -> torch.Tensor:
    """float32 (any shape; other float dtypes are cast) -> wire words."""
    if not cost.on_card(x):
        return kref.encode_ref(x, spec)
    code = build.format_code(spec, x.device,
                             widths=build.CODEC_WIDTHS)
    if cost.is_fake(x):
        out = torch.empty(x.shape, dtype=spec.word_dtype, device=x.device)
        cost.charge("takum_encode", 0, cost.nbytes(x) + cost.nbytes(out))
        return out
    x = build.aligned(x.to(torch.float32))
    out = torch.empty(x.shape, dtype=spec.word_dtype, device=x.device)
    err = _lib().takum_encode(spec.n, code, x.data_ptr(), out.data_ptr(),
                              x.numel(), build.stream_of(x))
    build.check(err, "takum_encode")
    encode.launches += 1
    return out


def kv_append(k: torch.Tensor, v: torch.Tensor, k_cache: torch.Tensor,
              v_cache: torch.Tensor, spec: FormatSpec, *, pos,
              table=None) -> None:
    """Encode fresh ``k``/``v [B, T, Hkv, hd]`` (any float dtype) to the
    cache's format and write them into ``k_cache``/``v_cache`` in place.

    Paged (``table [B, NP]`` int32 given, T = 1): a ``[P, ps, Hkv, hd]``
    pool, row b at ``(table[b, min(pos[b] // ps, NP - 1)], pos[b] % ps)``
    with ``pos [B]`` int32 on the card (an idle slot's stale pos lands on
    the page its clamped table entry names). Contiguous (``table`` None):
    a ``[B, Tmax, Hkv, hd]`` cache at positions ``pos .. pos + T - 1``
    (``pos`` an int). The identity codec casts to the float cache's dtype
    (bf16 or f32), wire formats encode (RNE, saturating).

    For CPU tensors the plain version encodes through this module's
    :func:`encode` (the plain codec there), K then V, so a caller that
    wraps ``takum_codec.encode`` sees every K/V encode in model order."""
    if not cost.on_card(k):
        kref.kv_append_ref(k, v, k_cache, v_cache, spec, pos=pos,
                           table=table, encode=encode)
        return
    code = build.format_code(spec, k.device,
                             kinds=("linear", "lns", "posit", "none"),
                             dtype=k_cache.dtype)
    want = k_cache.dtype if spec.is_identity else spec.word_dtype
    if k_cache.dtype != want or v_cache.dtype != want:
        raise TypeError(f"{spec.name} KV words must be {want}, got "
                        f"{k_cache.dtype} / {v_cache.dtype}")
    if k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         "be one [B, T, Hkv, hd] shape")
    b, t, hkv, hd = k.shape
    if (k_cache.shape != v_cache.shape or k_cache.shape[2:] != (hkv, hd)
            or hd % 4):
        raise ValueError(f"cache {tuple(k_cache.shape)} does not take k "
                         f"{tuple(k.shape)} (and hd must be a multiple "
                         "of 4)")
    if cost.is_fake(k):
        words = 2 * k.numel() * k_cache.element_size()
        cost.charge("kv_append", 0, cost.nbytes(k) + cost.nbytes(v) + words)
        return
    for c in (k_cache, v_cache):
        if (not c.is_cuda or c.device != k.device or not c.is_contiguous()
                or c.data_ptr() % 16):
            raise ValueError("the caches must be contiguous, 16-byte "
                             "aligned and on k's CUDA device: the words "
                             "are written in place")
    bf16 = k.dtype == torch.bfloat16 and v.dtype == torch.bfloat16
    dtype = torch.bfloat16 if bf16 else torch.float32
    k, v = (build.aligned(x.to(dtype)) for x in (k, v))
    bits = (build.IDENTITY_BITS[str(k_cache.dtype)] if spec.is_identity
            else spec.n)
    if table is not None:
        if t != 1:
            raise ValueError("a paged pool takes one position per row "
                             f"(decode steps), got T = {t}")
        ok = table.ndim == 2 and table.shape[0] == b and pos.shape == (b,)
        for x in (table, pos):
            ok = ok and (x.dtype == torch.int32 and x.device == k.device
                         and x.is_contiguous())
        if not ok:
            raise ValueError(f"the paged append takes pos [B] and table "
                             f"[B, NP] as contiguous int32 on the card, got "
                             f"{pos.dtype} {tuple(pos.shape)} and "
                             f"{table.dtype} {tuple(table.shape)}")
        geom = (k_cache.shape[1], table.shape[1], 0, 0)
        pos_ptr, table_ptr = pos.data_ptr(), table.data_ptr()
    else:
        pos = int(pos)
        if k_cache.shape[0] != b or not 0 <= pos <= k_cache.shape[1] - t:
            raise ValueError(f"cache {tuple(k_cache.shape)} cannot take "
                             f"{t} positions at {pos} for batch {b}")
        geom = (0, 0, pos, k_cache.shape[1])
        pos_ptr = table_ptr = None
    err = _lib().takum_kv_append(bits, code, int(bf16), k.data_ptr(),
                                 v.data_ptr(), k_cache.data_ptr(),
                                 v_cache.data_ptr(), pos_ptr, table_ptr, b,
                                 t, hkv, hd, *geom, build.stream_of(k))
    build.check(err, "takum_kv_append")
    kv_append.launches += 1


def _check_words(words: torch.Tensor, spec: FormatSpec) -> None:
    if words.dtype != spec.word_dtype:
        raise TypeError(f"{spec.name} words must be {spec.word_dtype}, "
                        f"got {words.dtype}")


decode.launches = 0
encode.launches = 0
kv_append.launches = 0
