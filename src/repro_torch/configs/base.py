"""Model configuration: ``ModelConfig``, the arch registry, ``parse_kv_quant``,
the training run's ``RuntimeConfig`` with its ``QuantConfig``, and the
four input shapes (``ShapeConfig``, ``SHAPES``, ``shape_applicable``).

The port's own copy of the JAX package's config dataclass (same field
names and defaults, so a config converts field by field), with its
parameter counts (``param_count``, ``active_param_count``: the
reference's formulas, used for 6ND model flops and the dry run's
report). Only the architectures this package can serve are registered.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

__all__ = ["ModelConfig", "ShapeConfig", "ArchSpec", "register_arch",
           "get_arch", "list_archs", "parse_kv_quant", "QuantConfig",
           "RuntimeConfig", "SHAPES", "shape_applicable"]


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

    def param_count(self) -> int:
        """Total parameter count (used for 6ND model flops): the
        reference's formula, approximations included (rwkv6's time mix,
        the RG-LRU's gates)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab
        hd = self.hd
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
            + self.n_heads * hd * d
        if self.activation == "swiglu":
            mlp = 3 * d * ff
        else:
            mlp = 2 * d * ff
        if self.family == "moe":
            mlp = self.n_experts * (3 * d * ff) + d * self.n_experts
        per_layer = attn + mlp + 2 * d
        if self.family == "rwkv6":
            # time-mix ~ 5 d^2-ish projections + decay MLPs, channel-mix 2*d*ff
            per_layer = 5 * d * d + 2 * d * ff + 2 * d
        if self.family == "hybrid_rglru":
            n_attn = sum(1 for i in range(self.n_layers)
                         if self._block_kind(i) == "attn")
            n_rec = self.n_layers - n_attn
            rec = 3 * d * self.lru_width + 2 * self.lru_width * \
                (self.lru_width // 256 or 1)  # conv/gates approx
            attn_l = attn + mlp + 2 * d
            rec_l = rec + mlp + 2 * d
            total = n_attn * attn_l + n_rec * rec_l
            total += V * d * (1 if self.tie_embeddings else 2)
            return total
        total = self.n_layers * per_layer
        if self.family == "encdec":
            total += self.n_enc_layers * per_layer  # + cross-attn below
            total += self.n_layers * (2 * d * self.n_kv_heads * hd
                                      + d * self.n_heads * hd)
        if self.family == "vlm" and self.cross_attn_every:
            n_cross = self.n_layers // self.cross_attn_every
            total += n_cross * (attn + mlp + 2 * d)
        total += V * d * (1 if self.tie_embeddings else 2)
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if self.family != "moe":
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        dense = self.param_count() - self.n_layers * self.n_experts * 3 * d * ff
        return dense + self.n_layers * self.top_k * 3 * d * ff

    def _block_kind(self, i: int) -> str:
        if not self.block_pattern:
            return "attn"
        return self.block_pattern[i % len(self.block_pattern)]


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


# the four input shapes of the dry run's cells, the reference's
SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch, shape) cell runs, and the reason when skipped:
    long_500k needs sub-quadratic sequence mixing, so only the rwkv6 and
    hybrid families take it."""
    if shape.name == "long_500k" and cfg.family not in ("rwkv6",
                                                        "hybrid_rglru"):
        return False, "long_500k skipped: pure full-attention architecture"
    return True, ""


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
