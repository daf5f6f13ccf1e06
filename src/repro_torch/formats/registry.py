"""The codec registry: a wire format as one ``FormatSpec`` value.

Every kernel, op, model and serving consumer resolves its format once at
its boundary (``resolve`` takes a spec, a registry name such as
``"takum8"``, a legacy ``(kind, n)`` pair, or a bare int width meaning
linear takum) and then dispatches on the spec's attributes.

Registered formats in this package: ``none`` (the identity codec: a
float tensor with a cast for decode), ``takum8`` and ``takum16`` (linear
takum), ``lns-takum8`` and ``lns-takum16`` (logarithmic takum: decode
pays one ``exp``, encode one ``log``; ``lns_parts`` gives the ``(ell,
flags)`` int32 lanes of the LNS matmul). ``decode_tile``/``encode_tile``
are the plain torch codec, dispatched on the kind; the CUDA kernels
inline the same functions from ``csrc/takum.cuh`` and are held against
these (bit-exact for the integer steps, to an ulp or two of ``exp``/
``log`` for the LNS conversions).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import takum

__all__ = ["FormatSpec", "IDENTITY", "get", "resolve", "resolve_wire",
           "resolve_lns", "names", "wire_names"]


@dataclasses.dataclass(frozen=True)
class FormatSpec:
    """A wire number format: identity and codec behaviour, as a value."""

    name: str      # registry key, e.g. "takum16"
    kind: str      # "linear" | "lns" | "none"
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

    def decode_tile(self, words, dtype=torch.float32) -> torch.Tensor:
        """Wire words -> float (NaR -> NaN); a cast for the identity."""
        if self.is_identity:
            return torch.as_tensor(words).to(dtype)
        if self.kind == "lns":
            return takum.lns_takum_to_float(words, self.n, dtype=dtype)
        return takum.takum_to_float(words, self.n, dtype=dtype)

    def encode_tile(self, x) -> torch.Tensor:
        """float32 -> wire words (RNE, saturating, NaN -> NaR); the
        identity codec passes the input through."""
        if self.is_identity:
            return torch.as_tensor(x)
        x = torch.as_tensor(x).to(torch.float32)
        if self.kind == "lns":
            return takum.float_to_lns_takum(x, self.n)
        return takum.float_to_takum(x, self.n)

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


IDENTITY = FormatSpec(name="none", kind="none", n=0)
_REGISTRY: Dict[str, FormatSpec] = {
    "none": IDENTITY,
    "takum8": FormatSpec(name="takum8", kind="linear", n=8),
    "takum16": FormatSpec(name="takum16", kind="linear", n=16),
    "lns-takum8": FormatSpec(name="lns-takum8", kind="lns", n=8),
    "lns-takum16": FormatSpec(name="lns-takum16", kind="lns", n=16),
}
_NAME_RE = re.compile(r"(lns-)?takum(\d+)$")
_KIND_NAME = {"linear": "takum{n}", "lns": "lns-takum{n}"}


def names() -> Tuple[str, ...]:
    return ("none", *sorted(k for k in _REGISTRY if k != "none"))


def wire_names() -> Tuple[str, ...]:
    return tuple(k for k in names() if k != "none")


def get(name: str) -> FormatSpec:
    if name not in _REGISTRY:
        raise ValueError(f"unknown format {name!r} "
                         f"(registered: {', '.join(names())})")
    return _REGISTRY[name]


def _kind(kind: str, n: int) -> FormatSpec:
    key = _KIND_NAME[kind].format(n=n)
    if key not in _REGISTRY:
        raise ValueError(f"format {key!r} is not in this package "
                         f"(registered: {', '.join(names())})")
    return _REGISTRY[key]


def resolve(fmt, n: Optional[int] = None) -> FormatSpec:
    """Resolve a spec, a name, a ``(kind, n)`` pair (``"linear"`` or
    ``"lns"``) or an int width (linear takum).

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
