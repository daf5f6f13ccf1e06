"""Flash attention over wire KV words: the CUDA kernels of
``csrc/attention.cu``.

Replaces ``repro/kernels/takum_attention.py::attention_kernel_call``
(contiguous cache: cached prefill chunks) and
``::paged_attention_kernel_call`` (paged pool: decode steps), over
takum8/16, lns-takum8/16 and posit8/16 KV words (posit8 through the
shared-memory table when ``spec.lut_decode``). Prefill
chunks are bound by f32 FLOPs, decode steps by the KV words' bytes; see
the source's header comment for the design and the semantics kept.

Both wrappers take the kernel layout ``q4 [B, Hkv, rows, hd]`` (row
``r`` = GQA group ``r // tq`` at position ``pos + r % tq``) and return
``[B, Hkv, rows, hd]`` f32. For CUDA tensors they launch the kernel; for
CPU tensors they run the plain version from ``kernels/ref.py`` on the
same inputs. ``fn.launches`` counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.formats import FormatSpec
from repro_torch.kernels import build
from repro_torch.kernels import ref as kref

__all__ = ["attention", "paged_attention", "to_rows", "from_rows",
           "DEFAULT_BK", "HEAD_DIMS"]

DEFAULT_BK = 256           # contiguous-cache KV tile (keys), as on the TPU
HEAD_DIMS = (16, 32, 64, 128)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "takum_attention": [_I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                        _I, _I, _I, _F, _P],
    "takum_paged_attention": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I,
                              _I, _I, _I, _I, _I, _F, _P],
}


def _lib():
    return build.library("attention", _SIGNATURES)


def to_rows(q: torch.Tensor, hkv: int) -> torch.Tensor:
    """[B, tq, H, hd] -> the kernel layout [B, Hkv, G * tq, hd]: row
    r = (group r // tq, query position pos + r % tq), so every row of a
    KV head shares its K/V tiles."""
    b, tq, h, hd = q.shape
    g = h // hkv
    return (q.reshape(b, tq, hkv, g, hd).permute(0, 2, 3, 1, 4)
            .reshape(b, hkv, g * tq, hd))


def from_rows(out4: torch.Tensor, tq: int) -> torch.Tensor:
    """The kernel layout [B, Hkv, G * tq, hd] -> [B, tq, H, hd]."""
    b, hkv, rows, hd = out4.shape
    g = rows // tq
    return (out4.reshape(b, hkv, g, tq, hd).permute(0, 3, 1, 2, 4)
            .reshape(b, tq, hkv * g, hd))


def _check(q4, kw, vw, spec) -> int:
    """Validate the inputs; returns the kernels' format code."""
    if spec.is_identity:
        raise NotImplementedError(
            "the CUDA attention kernels read wire KV words; float ('none') "
            "caches are not in this port yet")
    code = build.format_code(spec, q4.device)
    if kw.dtype != spec.word_dtype or vw.dtype != spec.word_dtype:
        raise TypeError(f"{spec.name} KV words must be {spec.word_dtype}")
    if q4.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head_dim {q4.shape[-1]} not in {HEAD_DIMS}")
    for t in (kw, vw):
        if not t.is_cuda or t.device != q4.device:
            raise ValueError("q4 and the KV words must share a CUDA device")
    return code


def attention(q4: torch.Tensor, kw: torch.Tensor, vw: torch.Tensor,
              pos: int, start=None, *, spec: FormatSpec, tq: int,
              bk=None, window: int = 0) -> torch.Tensor:
    """Contiguous cache ``kw``/``vw [B, T, Hkv, hd]``; ``pos`` (int) is
    the first query's position, ``start [B]`` the first valid key (None:
    0), ``bk`` the KV tile (default 256, clamped to T rounded up to 8;
    keys past ``T`` count as zero words, which the mask excludes)."""
    if not q4.is_cuda:
        out = kref.attention_ref(from_rows(q4, tq), kw, vw, spec.n, spec,
                                 pos=pos, start=start, window=window)
        return to_rows(out, kw.shape[2])
    code = _check(q4, kw, vw, spec)
    b, hkv, rows, hd = q4.shape
    if kw.shape != vw.shape or kw.shape[0] != b or kw.shape[2:] != (hkv, hd):
        raise ValueError(f"cache shape {tuple(kw.shape)} does not match q4 "
                         f"{tuple(q4.shape)}")
    if rows % tq:
        raise ValueError(f"rows {rows} not a multiple of tq {tq}")
    bk = min(bk or DEFAULT_BK, -(-kw.shape[1] // 8) * 8)
    q4 = q4.to(torch.float32).contiguous()
    kw, vw = kw.contiguous(), vw.contiguous()
    start = (torch.zeros(b, dtype=torch.int32, device=q4.device)
             if start is None else
             torch.as_tensor(start, device=q4.device).reshape(b)
             .to(torch.int32).contiguous())
    out = torch.empty_like(q4)
    err = _lib().takum_attention(
        spec.n, code, hd, q4.data_ptr(), kw.data_ptr(), vw.data_ptr(),
        out.data_ptr(), start.data_ptr(), b, hkv, rows, kw.shape[1],
        int(pos), tq, bk, window, hd ** -0.5, build.stream_of(q4))
    build.check(err, "takum_attention")
    build.launched(attention, code)
    return out


def _per_seq(x, b: int, dev) -> torch.Tensor:
    """A scalar or ``[B]`` vector -> a contiguous ``[B]`` int32 on dev."""
    return (torch.as_tensor(x, device=dev).reshape(-1).expand(b)
            .to(torch.int32).contiguous())


def paged_attention(q4: torch.Tensor, kw: torch.Tensor, vw: torch.Tensor,
                    pos, start, table, *, spec: FormatSpec,
                    window: int = 0) -> torch.Tensor:
    """One decode step over a page pool ``kw``/``vw [P, ps, Hkv, hd]``:
    ``pos``/``start [B]`` per sequence (``start`` None: 0), ``table
    [B, NP]`` page ids (reads clamped to ``NP - 1``). Rows are the G
    query heads of each KV head."""
    if not q4.is_cuda:
        out = kref.paged_attention_ref(from_rows(q4, 1), kw, vw, table, spec,
                                       pos=pos, start=start, window=window)
        return to_rows(out, kw.shape[2])
    code = _check(q4, kw, vw, spec)
    b, hkv, rows, hd = q4.shape
    if kw.shape != vw.shape or kw.shape[2:] != (hkv, hd):
        raise ValueError(f"pool shape {tuple(kw.shape)} does not match q4 "
                         f"{tuple(q4.shape)}")
    dev = q4.device
    table = torch.as_tensor(table, device=dev).to(torch.int32).contiguous()
    if table.shape[0] != b:
        raise ValueError(f"table {tuple(table.shape)} for batch {b}")
    q4 = q4.to(torch.float32).contiguous()
    kw, vw = kw.contiguous(), vw.contiguous()
    pos = _per_seq(pos, b, dev)
    start = _per_seq(0 if start is None else start, b, dev)
    out = torch.empty_like(q4)
    err = _lib().takum_paged_attention(
        spec.n, code, hd, q4.data_ptr(), kw.data_ptr(), vw.data_ptr(),
        out.data_ptr(), pos.data_ptr(), start.data_ptr(), table.data_ptr(),
        b, hkv, rows, kw.shape[1], table.shape[1], window, hd ** -0.5,
        build.stream_of(q4))
    build.check(err, "takum_paged_attention")
    build.launched(paged_attention, code)
    return out


attention.launches = 0
paged_attention.launches = 0
