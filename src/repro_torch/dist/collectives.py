"""Ring collectives with optional takum wire compression, on
``torch.distributed``.

Software rings over one process group (one mesh axis,
``launch/mesh.py``), each hop one :func:`transport`: a send to the next
rank of the group's ring and a receive from the previous one (the
reference's ``lax.ppermute`` inside ``shard_map``). They exist for two
reasons, as the reference's:

* **semantics**: per-hop wire compression with error-feedback residuals
  is not expressible through an all-reduce: the compression happens on
  the *partial sums in transit*, as a compressed hardware ring would;
* **accounting**: each hop moves ``G/size`` takum words instead of
  floats, so the bytes on the links are n/32 of f32.

A compressed hop's sender encodes its payload (the codec kernels on CUDA
tensors, ``kernels/ops.py::takum_encode``/``takum_decode``; their plain
versions on the CPU), decodes its own words for the residual
``x - wire``, and sends the **words**; the receiver decodes them. The
values are the reference's ``wire_roundtrip`` bit for bit. A
``core.quant.QuantSpec`` with a scale (``per_tensor``/``per_channel``)
sends its dequantised floats instead, as the reference does for every
spec: the receiver would need the scale too.

Conventions (the reference's):

* ``ring_reduce_scatter(x[G]) -> (chunk[G/size], residual[G])``: rank r
  ends with the full sum of chunk r; ``residual`` holds this rank's
  compression errors at the chunk slots it compressed (zeros when
  uncompressed).
* ``ring_all_gather(chunk[c]) -> full[c * size]`` ordered by rank.
* ``ring_all_reduce(x) -> (y, residual)``: reduce-scatter, then
  all-gather, over an internally padded chunking; residual as above, in
  ``x``'s shape.

Each takes the axis's process group and size in place of the reference's
``axis_name``. All three are the identity (with a zero residual) at size
1, so the single-device path needs no special case.

Transport: on NCCL, CUDA tensors go directly. gloo has no CUDA
send/recv, so there :func:`transport` copies a CUDA payload to host
memory, sends it, and moves the received bytes back to the device; it is
the only place that stages. Payloads travel as bytes (gloo has no
uint16/uint32). ``transport.hops``, ``.bytes_sent``, ``.staged`` and
``.seconds`` (the host's time inside it, the staging copies included)
count every hop this process sends, as the kernel wrappers count their
launches.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import formats
from repro_torch.core import quant
from repro_torch.kernels import ops

__all__ = ["wire_roundtrip", "encode_hop", "decode_hop", "hop_bytes",
           "transport",
           "ring_reduce_scatter", "ring_all_gather", "ring_all_reduce",
           "gather_encoded"]

# a QuantSpec's format family -> the registry's kind of the same words
_QUANT_KINDS = {"takum": "linear", "takum_lns": "lns", "posit": "posit"}


def _wire_format(spec):
    """(registry format of the words, scaled QuantSpec or None), or None
    for the uncompressed wire (no spec, the identity codec, a QuantSpec
    of ``fmt="none"``)."""
    if spec is None:
        return None
    if isinstance(spec, formats.FormatSpec):
        return None if spec.is_identity else (spec, None)
    if spec.fmt == "none":
        return None
    if spec.fmt not in _QUANT_KINDS:
        raise ValueError(f"unknown format {spec.fmt}")
    if spec.rounding != "rne":
        raise ValueError(f"the wire rounds to nearest even; {spec.rounding!r}"
                         " rounding needs a generator no hop has")
    fmt = formats.resolve(_QUANT_KINDS[spec.fmt], spec.n)
    return fmt, (None if spec.scale == "none" else spec)


def hop_bytes(spec, dtype=torch.float32) -> int:
    """The bytes an element of ``dtype`` takes on the wire under ``spec``:
    a word of an unscaled format, else the element itself."""
    codec = _wire_format(spec)
    if codec is None or codec[1] is not None:
        return torch.empty((), dtype=dtype).element_size()
    return codec[0].bytes_per_elem(dtype)


def encode_hop(x: torch.Tensor, spec, *, wire: bool = True
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One hop's sender: ``(payload, wire)``. ``wire`` is what every rank
    computes with (``dequant(quant(x))`` in ``x``'s dtype); ``payload``
    is what crosses the link: the words of an unscaled format, else
    ``wire`` itself (uncompressed, or a scaled QuantSpec). ``wire=False``
    skips the sender's decode of its own words (``wire`` is then None
    for them): a sender that keeps no residual needs only the payload."""
    codec = _wire_format(spec)
    if codec is None:
        return x, x
    fmt, scaled = codec
    x32 = x.to(torch.float32)
    if scaled is None:
        words = ops.takum_encode(x32, fmt)
        if not wire:
            return words, None
        return words, ops.takum_decode(words, fmt).to(x.dtype)
    k = quant.scale_exponent(x32, scaled)
    words = ops.takum_encode(x32 * quant.exp2i(k).to(x.device), fmt)
    wire = ops.takum_decode(words, fmt) * quant.exp2i(-k).to(x.device)
    wire = wire.to(x.dtype)
    return wire, wire


def decode_hop(payload: torch.Tensor, spec, dtype) -> torch.Tensor:
    """One hop's receiver: the wire values of a received ``payload``."""
    codec = _wire_format(spec)
    if codec is None or codec[1] is not None:
        return payload
    return ops.takum_decode(payload, codec[0]).to(dtype)


def wire_roundtrip(x: torch.Tensor, spec) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """One wire hop: ``(dequant(quant(x)), residual x - wire)``.

    ``spec=None`` is the uncompressed wire: exact, zero residual. ``spec``
    is a ``core.quant.QuantSpec`` (``scale="none"`` is the intended use:
    takum's range needs no scale side channel) or a registry
    ``formats.FormatSpec``: the serving stack compresses its TP
    activations with the formats its page pools use."""
    if _wire_format(spec) is None:
        return x, torch.zeros_like(x)
    _, wire = encode_hop(x, spec)
    return wire, x - wire


def transport(payload: torch.Tensor, group, size: int) -> torch.Tensor:
    """One ring hop over ``group`` (``size`` ranks): send ``payload`` to
    the next rank, receive the previous rank's tensor of the same shape
    and dtype, on ``payload``'s device. The payload moves as bytes; on
    gloo a CUDA payload is staged through host memory here (and nowhere
    else)."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % size)
    prv = dist.get_global_rank(group, (me - 1) % size)
    raw = payload.contiguous().reshape(-1).view(torch.uint8)
    # gloo has no CUDA send/recv: a CUDA payload goes through host memory
    # (as does the dry run's fake one, on cuda or meta)
    stage = (payload.device.type != "cpu"
             and dist.get_backend(group) != "nccl")
    if stage:
        raw = raw.cpu()
    got = torch.empty_like(raw)
    for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, raw, nxt,
                                                  group),
                                       dist.P2POp(dist.irecv, got, prv,
                                                  group)]):
        req.wait()
    if stage:
        got = got.to(payload.device)
    transport.hops += 1
    transport.bytes_sent += raw.numel()
    transport.staged += int(stage)
    transport.seconds += time.perf_counter() - t0
    return got.view(payload.dtype).reshape(payload.shape)


transport.hops = transport.bytes_sent = transport.staged = 0
transport.seconds = 0.0


def _rank(group) -> int:
    import torch.distributed as dist
    return dist.get_rank(group)


def ring_reduce_scatter(x: torch.Tensor, group, size: int, *, spec=None,
                        mean: bool = False, residual: bool = True):
    """Ring reduce-scatter of ``x [G]`` over ``group`` (G % size == 0).

    Chunk c starts at rank c + 1 and travels the ring gathering each
    rank's contribution, complete at rank c after size - 1 hops. Every
    hop's payload goes through the wire (``spec``); the sender's error is
    kept in the full-shape residual at that chunk's slot.
    ``residual=False`` returns None in its place and neither allocates it
    nor decodes the sender's own words (the chunk is the same): a caller
    that drops the residual, as the train step does at the gradients'
    size, saves a copy of ``x`` and a decode a hop."""
    if x.shape[-1] % size:
        raise ValueError(f"reduce_scatter: {x.shape[-1]} % {size} != 0")
    csize = x.shape[-1] // size
    if size == 1:
        out = x / size if mean else x
        return out, (torch.zeros_like(x) if residual else None)
    chunks = x.reshape(size, csize)
    r = _rank(group)
    resid = torch.zeros_like(chunks) if residual else None
    compressed = residual and _wire_format(spec) is not None
    # the partial sum in transit starts as this rank's copy of chunk r-1
    acc = chunks[(r - 1) % size]
    for t in range(size - 1):
        payload, wire = encode_hop(acc, spec, wire=residual)
        if compressed:
            resid[(r - 1 - t) % size] = acc - wire
        # the received values are this hop's own tensor: the sum takes it
        acc = decode_hop(transport(payload, group, size), spec, acc.dtype)
        acc += chunks[(r - 2 - t) % size]
    if mean:
        acc = acc / size
    return acc, (resid.reshape(x.shape) if residual else None)


def gather_encoded(payload: torch.Tensor, wire: torch.Tensor, spec, group,
                   size: int) -> torch.Tensor:
    """The all-gather ring of one encoded chunk per rank: ``payload`` (what
    :func:`encode_hop` sends) travels size - 1 hops and each arrival is
    decoded; ``wire`` is this rank's own values. ``[size * c]``, ordered
    by rank."""
    c = wire.shape[-1]
    r = _rank(group)
    out = torch.empty((size * c,), dtype=wire.dtype, device=wire.device)
    out[r * c:(r + 1) * c] = wire
    for t in range(1, size):
        payload = transport(payload, group, size)
        src = (r - t) % size
        out[src * c:(src + 1) * c] = decode_hop(payload, spec, wire.dtype)
    return out


def ring_all_gather(chunk: torch.Tensor, group, size: int, *, spec=None):
    """Ring all-gather: ``[c]`` a rank -> ``[size * c]``, ordered by rank.

    With ``spec`` the chunk is compressed once, at its owner: every rank,
    the owner too, then uses the same wire values."""
    if size == 1:
        return chunk
    payload, wire = encode_hop(chunk, spec)
    return gather_encoded(payload, wire, spec, group, size)


def ring_all_reduce(x: torch.Tensor, group, size: int, *, spec=None,
                    mean: bool = False):
    """Compressed ring all-reduce: reduce-scatter, then all-gather.

    Returns ``(y, residual)``: ``residual`` is this rank's whole
    compression error (the reduce-scatter hops at their chunk slots and
    the all-gather's compression of its own chunk), in ``x``'s shape: the
    error-feedback state a caller carries."""
    shape = x.shape
    if size == 1:
        out = x / size if mean else x
        return out, torch.zeros_like(x)
    flat = x.reshape(-1)
    pad = (-flat.numel()) % size
    if pad:
        flat = F.pad(flat, (0, pad))
    csize = flat.numel() // size
    chunk, resid = ring_reduce_scatter(flat, group, size, spec=spec)
    payload, wire = encode_hop(chunk, spec)
    r = _rank(group)
    if _wire_format(spec) is not None:
        resid[r * csize:(r + 1) * csize] = chunk - wire
    # the chunk went through the wire once: its words are what travels
    full = gather_encoded(payload, wire, spec, group, size)
    if mean:
        full = full / size
    if pad:
        full = full[:-pad]
        resid = resid[:-pad]
    return full.reshape(shape), resid.reshape(shape)
