"""Model configuration: ``ModelConfig``, the arch registry, ``parse_kv_quant``,
and the training run's ``RuntimeConfig`` with its ``QuantConfig``.

The port's own copy of the JAX package's config dataclass (same field
names and defaults, so a config converts field by field). Only the
architectures this package can serve are registered.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

__all__ = ["ModelConfig", "ArchSpec", "register_arch", "get_arch",
           "list_archs", "parse_kv_quant", "QuantConfig", "RuntimeConfig"]


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
    family: str                  # dense | moe | hybrid_rglru | rwkv6 | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int                 # query heads
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    activation: str = "swiglu"   # swiglu | relu2 | gelu
    rope_base: float = 10_000.0
    tie_embeddings: bool = False  # unembed by embed_tokens^T
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # hybrid (RecurrentGemma): block pattern, e.g. ("rec", "rec", "attn")
    block_pattern: Tuple[str, ...] = ()
    lru_width: int = 0
    window: int = 0              # sliding-window size of local attention
    # rwkv6
    rwkv_head_dim: int = 64
    # enc-dec
    n_enc_layers: int = 0        # encoder layers (encdec family)
    # vlm
    cross_attn_every: int = 0    # a cross-attention layer every k layers
    n_media_tokens: int = 1601   # stubbed frontend sequence length
    d_media: int = 0             # media embedding dim (0 -> d_model)
    # modality frontend stub: 'none' | 'vision' | 'audio'
    frontend: str = "none"
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
class QuantConfig:
    """The wire formats of a run (the reference's fields and defaults);
    the train step reads ``grad_allreduce``, the gradient compression of
    the manual data-parallel rings (``train/trainer.py::
    grad_spec_from_quant``)."""
    weights: str = "none"      # 'none' | 'takum8' | 'takum16' | 'posit16' ...
    kv_cache: str = "none"
    grad_allreduce: str = "none"   # cross-pod gradient compression
    checkpoint: str = "none"


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """The train step's options, the reference's fields and defaults. The
    steps read ``remat`` and ``microbatch``, the launcher ``quant``;
    ``zero1`` (the manual step always shards its optimizer state over
    ``data``), ``multi_pod`` and ``seq_shard`` are carried as the
    reference carries them."""
    multi_pod: bool = False
    remat: str = "block"       # 'none' | 'block' (per-layer rematerialisation)
    zero1: bool = True         # shard optimizer state over data axes
    microbatch: int = 0        # 0 = no microbatching
    seq_shard: bool = True     # sequence/context parallel annotations
    quant: QuantConfig = dataclasses.field(default_factory=QuantConfig)


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
