"""Model configuration: ``ModelConfig``, the arch registry, ``parse_kv_quant``,
and the training run's ``RuntimeConfig``.

The port's own copy of the JAX package's config dataclass (same field
names and defaults, so a config converts field by field). Only the
architectures this package can serve are registered.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

__all__ = ["ModelConfig", "ArchSpec", "register_arch", "get_arch",
           "list_archs", "parse_kv_quant", "RuntimeConfig"]


def parse_kv_quant(kv_quant: str) -> Tuple[str, int]:
    """``ModelConfig.kv_quant`` -> ``(kind, n)`` through the registry;
    unknown names raise with the registered ones."""
    from repro_torch import formats
    try:
        spec = formats.resolve(kv_quant)
    except ValueError as e:
        raise ValueError(f"unknown kv_quant {kv_quant!r}: {e}") from None
    return spec.kind, spec.n


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe (the families served here)
    n_layers: int
    d_model: int
    n_heads: int                 # query heads
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    activation: str = "swiglu"   # the only MLP served here
    rope_base: float = 10_000.0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    dtype: str = "bf16"          # activation compute dtype
    param_dtype: str = "f32"
    # serving: KV-cache wire format, a repro_torch.formats name
    kv_quant: str = "none"
    # KV tile of the contiguous-cache attention kernel (0 -> 256)
    kv_block: int = 0

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """The single-device train step's options: the reference's
    ``RuntimeConfig`` without its multi-device fields (``multi_pod``,
    ``zero1``, ``seq_shard`` and the ``QuantConfig`` of gradient
    compression), which come with the multi-device modules (ROADMAP.md
    section 1 item 6)."""
    remat: str = "block"       # 'none' | 'block' (per-layer rematerialisation)
    microbatch: int = 0        # 0 = no microbatching


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    config: ModelConfig
    reduced: ModelConfig    # small same-family config for CPU tests
    source: str


_REGISTRY: Dict[str, Callable[[], ArchSpec]] = {}


def register_arch(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_arch(name: str) -> ArchSpec:
    import repro_torch.configs  # noqa: F401  (registration side effects)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs():
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)
