"""The codec registry: a wire format as one ``FormatSpec`` value.

Every kernel, op, model and serving consumer resolves its format once at
its boundary (``resolve`` takes a spec, a registry name such as
``"takum8"``, a legacy ``(kind, n)`` pair, or a bare int width meaning
linear takum) and then dispatches on the spec's attributes.

Registered formats in this package: ``none`` (the identity codec: a
float tensor with a cast for decode), ``takum8`` and ``takum16`` (linear
takum), ``lns-takum8`` and ``lns-takum16`` (logarithmic takum: decode
pays one ``exp``, encode one ``log``; ``lns_parts`` gives the ``(ell,
flags)`` int32 lanes of the LNS matmul), ``posit8`` and ``posit16`` (the
paper's baseline, es = 2, FloPoCo-2C decode). ``decode_tile``/
``encode_tile`` are the plain torch codec, dispatched on the kind; the
CUDA kernels inline the same functions from ``csrc/takum.cuh`` and
``csrc/posit.cuh`` and are held against these (bit-exact for the integer
steps, to an ulp or two of ``exp``/``log`` for the LNS conversions).

Other widths (``"takum12"``, ``"posit32"``, ``"lns-takum24"``,
``"takum64"``, the ``(kind, n)`` pairs and bare ints; 6 <= n <= 64 in the
codec, uint64 words from n = 33; n = 65 is refused by ``word_dtype``)
resolve on demand and are interned, as the reference's: ``resolve``
returns the same object for the same format, and ``names()`` stays the
registered seven. Only the codec and fake-quant kernels take them on the
card (``kernels/build.py``, ``format_code``). ``decode_tile`` decodes to
float32 or float64 directly (float64 is exact for every takum and posit
word to 57 bits, whose fraction fits its 52 bits).

posit8 also decodes through a 256-entry table (``has_lut``): its plain
version here builds the table with the computed decode and gathers once
per word; the CUDA kernels keep the table in shared memory. Whether the
table is used is :func:`lut_enabled`'s choice, read per call;
``fake_quant`` is the quantise-dequantise policy of the serving path
(power-of-two centring for linear takum, the unscaled round trip for the
other formats).
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import posit, takum

__all__ = ["FormatSpec", "IDENTITY", "get", "resolve", "resolve_wire",
           "resolve_lns", "names", "wire_names", "lut_enabled",
           "posit8_lut_decode", "LUT_DEFAULT_CUDA"]

# Whether posit8 decodes through its shared-memory table on the card when
# REPRO_LUT_DECODE is unset: on. On an H100 the table beat the computed
# decode in every kernel that decodes posit8 words (codec, wire matmul,
# both attention kernels, fake-quant); chip_smoke.py phases 12-14 and 17
# time both, and PERF.md records the times.
LUT_DEFAULT_CUDA = True


def lut_enabled(device=None) -> bool:
    """Whether table decodes are on, for tensors on ``device``.

    ``REPRO_LUT_DECODE=1`` forces the table on, ``0`` forces it off (read
    per call, as the reference does). Unset: :data:`LUT_DEFAULT_CUDA` on
    the card, off elsewhere (the reference's default off the TPU; on the
    CPU the two paths give the same floats)."""
    v = os.environ.get("REPRO_LUT_DECODE", "")
    if v == "1":
        return True
    if v == "0":
        return False
    return (LUT_DEFAULT_CUDA and device is not None
            and torch.device(device).type == "cuda")


@dataclasses.dataclass(frozen=True)
class FormatSpec:
    """A wire number format: identity and codec behaviour, as a value."""

    name: str      # registry key, e.g. "takum16"
    kind: str      # "linear" | "lns" | "posit" | "none"
    n: int         # word width in bits (0 = identity)

    @property
    def is_identity(self) -> bool:
        return self.kind == "none"

    @property
    def word_dtype(self) -> Optional[torch.dtype]:
        """Wire storage dtype (``None`` for the identity codec)."""
        return None if self.is_identity else takum.word_dtype(self.n)

    def bytes_per_elem(self, dtype=torch.float32) -> int:
        if self.is_identity:
            return torch.empty((), dtype=dtype).element_size()
        return torch.empty((), dtype=self.word_dtype).element_size()

    @property
    def nar_word(self) -> Optional[int]:
        return None if self.is_identity else takum.nar_word(self.n)

    @property
    def zero_word(self) -> int:
        """The zero word, also the padding word: it decodes to 0.0."""
        return 0

    @property
    def has_lut(self) -> bool:
        """Whether a table decode exists (posit8 only: 256 entries)."""
        return self.kind == "posit" and self.n == 8

    def lut_decode(self, device=None) -> bool:
        """Whether decodes of words on ``device`` take the table now."""
        return self.has_lut and lut_enabled(device)

    def decode_tile(self, words, dtype=torch.float32) -> torch.Tensor:
        """Wire words -> float (NaR -> NaN); a cast for the identity.
        posit8 takes the table when :meth:`lut_decode` says so (the same
        floats, bit for bit)."""
        if self.is_identity:
            return torch.as_tensor(words).to(dtype)
        if self.kind == "lns":
            return takum.lns_takum_to_float(words, self.n, dtype=dtype)
        if self.kind == "posit":
            words = torch.as_tensor(words)
            if self.lut_decode(words.device):
                return posit8_lut_decode(words, dtype=dtype)
            return posit.posit_to_float(words, self.n, dtype=dtype)
        return takum.takum_to_float(words, self.n, dtype=dtype)

    def encode_tile(self, x) -> torch.Tensor:
        """float32 -> wire words (RNE, saturating, NaN -> NaR); the
        identity codec passes the input through."""
        if self.is_identity:
            return torch.as_tensor(x)
        x = torch.as_tensor(x).to(torch.float32)
        if self.kind == "lns":
            return takum.float_to_lns_takum(x, self.n)
        if self.kind == "posit":
            return posit.float_to_posit(x, self.n)
        return takum.float_to_takum(x, self.n)

    def fake_quant(self, x, dtype=torch.float32, *,
                   scale_exp=None) -> torch.Tensor:
        """Quantise-dequantise through this format's grid (the serving
        policy of ``quantize_weights(mode="fake")``).

        Linear takum scales by a power of two, 2^k (``scale_exp`` = k, by
        default the per-tensor centring of ``core.quant``: precision peaks
        at |x| ~ 1); the other wire formats round-trip unscaled. Runs the
        fused fake-quant kernel for CUDA tensors and its plain version
        for CPU tensors."""
        from repro_torch.core import quant
        from repro_torch.kernels import quantize
        x = torch.as_tensor(x)
        if self.is_identity:
            return x.to(dtype)
        if self.kind != "linear":
            if scale_exp:
                raise ValueError(f"{self.name} fake-quantises unscaled")
            return quantize.fake_quant(x, self, dtype=dtype)
        if scale_exp is None:
            scale_exp = int(quant.scale_exponent(
                x.to(torch.float32), quant.QuantSpec(fmt="takum", n=self.n)))
        return quantize.fake_quant(x, self, dtype=dtype, scale_exp=scale_exp)

    @property
    def has_lns_parts(self) -> bool:
        """Whether the format has the ell_bar datapath (the LNS matmul
        takes only such words)."""
        return self.kind == "lns"

    def lns_parts(self, words):
        """``(ell, flags)`` int32 lanes (``takum.decode_lns_parts``); only
        for ``has_lns_parts`` specs."""
        if not self.has_lns_parts:
            raise ValueError(f"format {self.name!r} has no LNS ell_bar "
                             "datapath (only the lns-takum formats do)")
        return takum.decode_lns_parts(words, self.n)


def posit8_lut_decode(words, dtype=torch.float32) -> torch.Tensor:
    """posit8 words -> float through the 256-entry table: the plain
    version of the reference's ``_posit8_lut_decode``. The table is built
    by the computed decode, then one gather per word."""
    words = torch.as_tensor(words)
    if words.dtype != torch.uint8:
        raise TypeError(f"posit8 words must be uint8, got {words.dtype}")
    idx = torch.arange(256, dtype=torch.int64, device=words.device)
    tab = posit.posit_to_float(idx.to(torch.uint8), 8, dtype=dtype)
    return tab[words.to(torch.int64)]


IDENTITY = FormatSpec(name="none", kind="none", n=0)
_REGISTRY: Dict[str, FormatSpec] = {
    "none": IDENTITY,
    "takum8": FormatSpec(name="takum8", kind="linear", n=8),
    "takum16": FormatSpec(name="takum16", kind="linear", n=16),
    "lns-takum8": FormatSpec(name="lns-takum8", kind="lns", n=8),
    "lns-takum16": FormatSpec(name="lns-takum16", kind="lns", n=16),
    "posit8": FormatSpec(name="posit8", kind="posit", n=8),
    "posit16": FormatSpec(name="posit16", kind="posit", n=16),
}
_NAME_RE = re.compile(r"(lns-)?takum(\d+)$|posit(\d+)$")
_KIND_NAME = {"linear": "takum{n}", "lns": "lns-takum{n}",
              "posit": "posit{n}"}


def names() -> Tuple[str, ...]:
    return ("none", *sorted(k for k in _REGISTRY if k != "none"))


def wire_names() -> Tuple[str, ...]:
    return tuple(k for k in names() if k != "none")


def get(name: str) -> FormatSpec:
    if name not in _REGISTRY:
        raise ValueError(f"unknown format {name!r} "
                         f"(registered: {', '.join(names())})")
    return _REGISTRY[name]


_INTERNED: Dict[str, FormatSpec] = {}


def _kind(kind: str, n: int) -> FormatSpec:
    """The registered spec of (kind, n), or one made and interned on
    demand (the same object for the same format every time)."""
    if not isinstance(n, int) or n < 2:
        raise ValueError(f"format kind {kind!r} needs a word width n, "
                         f"got {n!r}")
    key = _KIND_NAME[kind].format(n=n)
    spec = _REGISTRY.get(key) or _INTERNED.get(key)
    if spec is None:
        spec = _INTERNED[key] = FormatSpec(name=key, kind=kind, n=n)
    return spec


def resolve(fmt, n: Optional[int] = None) -> FormatSpec:
    """Resolve a spec, a name, a ``(kind, n)`` pair (``"linear"``,
    ``"lns"`` or ``"posit"``) or an int width (linear takum).

    A width passed beside a format that carries its own must agree."""
    if isinstance(fmt, FormatSpec):
        spec = fmt
    elif isinstance(fmt, int) and not isinstance(fmt, bool):
        spec = _kind("linear", fmt)
    elif isinstance(fmt, str) and fmt in _KIND_NAME:
        if not n:
            raise ValueError(f"format kind {fmt!r} needs a word width n")
        spec = _kind(fmt, int(n))
    elif isinstance(fmt, str) and fmt in _REGISTRY:
        spec = _REGISTRY[fmt]
    elif isinstance(fmt, str) and _NAME_RE.fullmatch(fmt):
        m = _NAME_RE.fullmatch(fmt)
        if m.group(3) is not None:
            spec = _kind("posit", int(m.group(3)))
        else:
            spec = _kind("lns" if m.group(1) else "linear", int(m.group(2)))
    else:
        raise ValueError(f"unknown format {fmt!r} "
                         f"(registered: {', '.join(names())})")
    if n and spec.n and int(n) != spec.n:
        raise ValueError(f"width mismatch: format {spec.name!r} "
                         f"(n={spec.n}) but n={n} was passed alongside")
    return spec


def resolve_lns(fmt, n: Optional[int] = None) -> FormatSpec:
    """Like :func:`resolve`, but a bare int width means the logarithmic
    takum of that width (the default of the LNS matmul entry points)."""
    if isinstance(fmt, int) and not isinstance(fmt, bool):
        return _kind("lns", fmt)
    return resolve(fmt, n)


def resolve_wire(fmt, n: Optional[int] = None) -> FormatSpec:
    """Like :func:`resolve`, but rejects the identity codec."""
    spec = resolve(fmt, n)
    if spec.is_identity:
        raise ValueError(f"format {fmt!r} is the identity codec; expected "
                         f"a wire format ({', '.join(wire_names())})")
    return spec
