"""Flash attention over wire KV words: the CUDA kernels of
``csrc/flash_attention.cu`` and ``csrc/attention.cu``.

Replaces ``repro/kernels/takum_attention.py::attention_kernel_call``
(contiguous cache: cached prefill chunks, ``csrc/flash_attention.cu``, on
the tensor cores) and ``::paged_attention_kernel_call`` (paged pool:
decode steps, ``csrc/attention.cu``), over takum8/16, lns-takum8/16 and
posit8/16 KV words (posit8 through the shared-memory table when
``spec.lut_decode``) and the identity codec's bf16 or f32 float caches.
Prefill chunks are bound by their products, decode steps by the KV
words' bytes; see the sources' header comments for the designs and the
semantics kept.

A float cache is cast to f32 inside the kernels and every dot runs at
f32 precision, as the reference's Pallas kernels do (``kv_words_to_f32``
and ``preferred_element_type=f32``). The plain version's identity branch
instead runs its einsums in the cache dtype, so against it a bf16 cache
agrees only to bf16 rounding (the card tests state the tolerance).

Paged attention runs as flash-decoding: each sequence's in-band keys are
cut into partitions of :func:`paged_partition_keys` keys
(:func:`paged_partitions` is the plan), one block a partition and KV head,
and the last block of a (sequence, KV head) to finish merges its
partitions in order, in the same launch.

Both wrappers take the kernel layout ``q4 [B, Hkv, rows, hd]`` (row
``r`` = GQA group ``r // tq`` at position ``pos + r % tq``) and return
``[B, Hkv, rows, hd]`` f32. For CUDA tensors they launch the kernel; for
CPU tensors they run the plain version from ``kernels/ref.py`` on the
same inputs. ``fn.launches`` counts launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.formats import FormatSpec
from repro_torch.kernels import build
from repro_torch.kernels import ref as kref

__all__ = ["attention", "paged_attention", "to_rows", "from_rows",
           "DEFAULT_BK", "HEAD_DIMS", "paged_partition_keys",
           "paged_partitions"]

DEFAULT_BK = 256           # contiguous-cache KV tile (keys), as on the TPU
HEAD_DIMS = (16, 32, 64, 112, 128)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the C entry point of each library
_SIGNATURES = {
    "flash_attention": {"takum_attention": [_I, _I, _I, _P, _P, _P, _P, _P,
                                            _I, _I, _I, _I, _I, _I, _I, _I,
                                            _F, _P]},
    "attention": {"takum_paged_attention": [_I, _I, _I, _P, _P, _P, _P, _P,
                                            _P, _P, _P, _P, _P, _I, _I, _I,
                                            _I, _I, _I, _F, _I, _P]},
}
# paged attention's per-(sequence, KV head) counters, by device and stream:
# zero between calls (each launch's last blocks reset theirs)
_COUNTERS: Dict[Tuple[str, int], torch.Tensor] = {}


def _lib(name: str):
    return build.library(name, _SIGNATURES[name])


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


def _check(q4, kw, vw, spec):
    """Validate the inputs; returns the kernels' (word bits, format
    code)."""
    code = build.format_code(spec, q4.device,
                             kinds=("linear", "lns", "posit", "none"),
                             dtype=kw.dtype)
    want = kw.dtype if spec.is_identity else spec.word_dtype
    if kw.dtype != want or vw.dtype != want:
        raise TypeError(f"{spec.name} KV words must be {want}, got "
                        f"{kw.dtype} / {vw.dtype}")
    if q4.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head_dim {q4.shape[-1]} not in {HEAD_DIMS}")
    for t in (kw, vw):
        if not t.is_cuda or t.device != q4.device:
            raise ValueError("q4 and the KV words must share a CUDA device")
    bits = build.IDENTITY_BITS[str(kw.dtype)] if spec.is_identity else spec.n
    return bits, code


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
    bits, code = _check(q4, kw, vw, spec)
    b, hkv, rows, hd = q4.shape
    if kw.shape != vw.shape or kw.shape[0] != b or kw.shape[2:] != (hkv, hd):
        raise ValueError(f"cache shape {tuple(kw.shape)} does not match q4 "
                         f"{tuple(q4.shape)}")
    if rows % tq:
        raise ValueError(f"rows {rows} not a multiple of tq {tq}")
    bk = min(bk or DEFAULT_BK, -(-kw.shape[1] // 8) * 8)
    q4 = build.aligned(q4.to(torch.float32))
    kw, vw = build.aligned(kw), build.aligned(vw)
    start = (torch.zeros(b, dtype=torch.int32, device=q4.device)
             if start is None else
             torch.as_tensor(start, device=q4.device).reshape(b)
             .to(torch.int32).contiguous())
    out = torch.empty_like(q4)
    err = _lib("flash_attention").takum_attention(
        bits, code, hd, q4.data_ptr(), kw.data_ptr(), vw.data_ptr(),
        out.data_ptr(), start.data_ptr(), b, hkv, rows, kw.shape[1],
        int(pos), tq, bk, window, hd ** -0.5, build.stream_of(q4))
    build.check(err, "takum_attention")
    build.launched(attention, code)
    return out


def _i32(x, dev) -> torch.Tensor:
    """``x`` as a contiguous int32 tensor on ``dev`` (as it is when it
    already is one: a decode step calls this per layer)."""
    if (isinstance(x, torch.Tensor) and x.dtype == torch.int32
            and x.device == dev and x.is_contiguous()):
        return x
    return torch.as_tensor(x, device=dev).to(torch.int32).contiguous()


def _per_seq(x, b: int, dev) -> torch.Tensor:
    """A scalar or ``[B]`` vector -> a contiguous ``[B]`` int32 on dev."""
    x = _i32(x, dev)
    return x if x.shape == (b,) else x.reshape(-1).expand(b).contiguous()


def paged_partition_keys(hd: int, bits: int) -> int:
    """Keys of a paged-attention partition for ``hd``-wide keys of
    ``bits``-bit words (``csrc/attention.cu``, ``Geo``): a key is read by
    ``lpk = hd * bits / 128`` lanes of 16 bytes, a warp holds ``32 //
    lpk`` whole keys (at hd 112 a takum8 key is 7 lanes, 4 keys a warp
    and 4 lanes idle), and each of a block's 4 warps loads ``bits / 2``
    such sets of K and of V. That is 8192 / hd keys at a power-of-two hd
    (8192 K words and as many V words), 64 at hd 112 for every width."""
    if hd * bits < 128 or hd * bits % 128:
        raise ValueError(f"paged attention reads keys of whole 16-byte "
                         f"pieces, got hd {hd} x {bits} bits")
    lpk = hd * bits // 128
    if lpk > 32:
        raise ValueError(f"a key of hd {hd} x {bits} bits does not fit "
                         "one warp's lanes")
    return (bits // 2) * 4 * (32 // lpk)


def paged_partitions(pos, ps: int, npg: int, window: int, pk: int):
    """The partition plan of paged attention: for each sequence (``pos``
    a sequence of ints), the key ranges ``(k0, k1)`` of its partitions in
    merge order.

    A sequence's in-band pages are ``first..last``: ``last = min(pos //
    ps, npg - 1)`` (a stale ``pos`` is clamped to the table), ``first`` 0
    or, with a window, the page of the window floor ``pos - window + 1``;
    ``first > last`` leaves none. Their keys ``first * ps .. (last + 1) *
    ps - 1`` are cut into ranges of ``pk`` keys, the last one shorter. The
    kernel's grid holds ``ceil(npg * ps / pk)`` partitions for every
    sequence; those past a sequence's ranges visit no key and take no
    part in the merge."""
    plans = []
    for p in pos:
        p = int(p)
        last = min(p // ps, npg - 1)
        first = max((p - window + 1) // ps, 0) if window else 0
        if first > last:
            plans.append([])
            continue
        lo, hi = first * ps, (last + 1) * ps
        plans.append([(k, min(k + pk, hi)) for k in range(lo, hi, pk)])
    return plans


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
    bits, code = _check(q4, kw, vw, spec)
    b, hkv, rows, hd = q4.shape
    if kw.shape != vw.shape or kw.shape[2:] != (hkv, hd):
        raise ValueError(f"pool shape {tuple(kw.shape)} does not match q4 "
                         f"{tuple(q4.shape)}")
    dev = q4.device
    table = _i32(table, dev)
    if table.shape[0] != b:
        raise ValueError(f"table {tuple(table.shape)} for batch {b}")
    if q4.dtype != torch.float32 or not q4.is_contiguous():
        q4 = q4.to(torch.float32).contiguous()
    kw, vw = build.aligned(kw), build.aligned(vw)
    pos = _per_seq(pos, b, dev)
    start = _per_seq(0 if start is None else start, b, dev)
    ps, npg = kw.shape[1], table.shape[1]
    parts = -(-npg * ps // paged_partition_keys(hd, bits))
    out = torch.empty_like(q4)
    # the partitions' acc [B, Hkv, parts, rows, hd] and (m, l) pairs
    work = torch.empty(b * hkv * parts * rows * (hd + 2),
                       dtype=torch.float32, device=dev)
    part_ml = work[b * hkv * parts * rows * hd:]
    stream = build.stream_of(q4)
    key = (str(dev), stream)
    counter = _COUNTERS.get(key)
    if counter is None or counter.numel() < b * hkv:
        counter = torch.zeros(max(b * hkv, 256), dtype=torch.int32,
                              device=dev)
        _COUNTERS[key] = counter
    err = _lib("attention").takum_paged_attention(
        bits, code, hd, q4.data_ptr(), kw.data_ptr(), vw.data_ptr(),
        out.data_ptr(), work.data_ptr(), part_ml.data_ptr(),
        counter.data_ptr(), pos.data_ptr(), start.data_ptr(),
        table.data_ptr(), b, hkv, rows, ps, npg, window, hd ** -0.5, parts,
        stream)
    build.check(err, "takum_paged_attention")
    build.launched(paged_attention, code)
    return out


attention.launches = 0
paged_attention.launches = 0
