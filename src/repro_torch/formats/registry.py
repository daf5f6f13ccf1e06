"""The codec registry: a wire format as one ``FormatSpec`` value.

Every kernel, op, model and serving consumer resolves its format once at
its boundary (``resolve`` takes a spec, a registry name such as
``"takum8"``, a legacy ``(kind, n)`` pair, or a bare int width meaning
linear takum) and then dispatches on the spec's attributes.

Registered formats in this package: ``none`` (the identity codec: a
float tensor with a cast for decode), ``takum8`` and ``takum16`` (linear
takum). ``decode_tile``/``encode_tile`` are the plain torch codec; the
CUDA kernels inline the same functions from ``csrc/takum.cuh`` and are
held bit-exact against these.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import takum

__all__ = ["FormatSpec", "IDENTITY", "get", "resolve", "resolve_wire",
           "names", "wire_names"]


@dataclasses.dataclass(frozen=True)
class FormatSpec:
    """A wire number format: identity and codec behaviour, as a value."""

    name: str      # registry key, e.g. "takum16"
    kind: str      # "linear" | "none"
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
        return takum.takum_to_float(words, self.n, dtype=dtype)

    def encode_tile(self, x) -> torch.Tensor:
        """float32 -> wire words (RNE, saturating, NaN -> NaR); the
        identity codec passes the input through."""
        if self.is_identity:
            return torch.as_tensor(x)
        return takum.float_to_takum(torch.as_tensor(x).to(torch.float32),
                                    self.n)


IDENTITY = FormatSpec(name="none", kind="none", n=0)
_REGISTRY: Dict[str, FormatSpec] = {
    "none": IDENTITY,
    "takum8": FormatSpec(name="takum8", kind="linear", n=8),
    "takum16": FormatSpec(name="takum16", kind="linear", n=16),
}
_NAME_RE = re.compile(r"takum(\d+)$")


def names() -> Tuple[str, ...]:
    return ("none", *sorted(k for k in _REGISTRY if k != "none"))


def wire_names() -> Tuple[str, ...]:
    return tuple(k for k in names() if k != "none")


def get(name: str) -> FormatSpec:
    if name not in _REGISTRY:
        raise ValueError(f"unknown format {name!r} "
                         f"(registered: {', '.join(names())})")
    return _REGISTRY[name]


def _linear(n: int) -> FormatSpec:
    key = f"takum{n}"
    if key not in _REGISTRY:
        raise ValueError(f"format {key!r} is not in this package "
                         f"(registered: {', '.join(names())})")
    return _REGISTRY[key]


def resolve(fmt, n: Optional[int] = None) -> FormatSpec:
    """Resolve a spec, a name, a ``("linear", n)`` pair or an int width.

    A width passed beside a format that carries its own must agree."""
    if isinstance(fmt, FormatSpec):
        spec = fmt
    elif isinstance(fmt, int) and not isinstance(fmt, bool):
        spec = _linear(fmt)
    elif fmt == "linear":
        if not n:
            raise ValueError("format kind 'linear' needs a word width n")
        spec = _linear(int(n))
    elif isinstance(fmt, str) and fmt in _REGISTRY:
        spec = _REGISTRY[fmt]
    elif isinstance(fmt, str) and _NAME_RE.fullmatch(fmt):
        spec = _linear(int(_NAME_RE.fullmatch(fmt).group(1)))
    else:
        raise ValueError(f"unknown format {fmt!r} "
                         f"(registered: {', '.join(names())})")
    if n and spec.n and int(n) != spec.n:
        raise ValueError(f"width mismatch: format {spec.name!r} "
                         f"(n={spec.n}) but n={n} was passed alongside")
    return spec


def resolve_wire(fmt, n: Optional[int] = None) -> FormatSpec:
    """Like :func:`resolve`, but rejects the identity codec."""
    spec = resolve(fmt, n)
    if spec.is_identity:
        raise ValueError(f"format {fmt!r} is the identity codec; expected "
                         f"a wire format ({', '.join(wire_names())})")
    return spec
