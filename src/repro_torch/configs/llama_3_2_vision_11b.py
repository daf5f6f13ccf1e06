"""llama-3.2-vision-11b [vlm]: a cross-attention layer every 5th layer.
[hf:meta-llama/Llama-3.2-11B-Vision]

The reference's configuration, copied as the reference has it: 40
layers in the pattern (cross, self, self, self, self), d 4096, 32/8
heads of 128, a SwiGLU MLP of 14336, and a 128256-token vocabulary. The
vision frontend is a stub: the cross-attention layers take pre-projected
patch embeddings [B, 1601, 4096]. Cross-attention layers hold no paged
state, so the family is served through lockstep generation."""

import dataclasses

from repro_torch.configs.base import ArchSpec, ModelConfig, register_arch

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4_096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    vocab=128_256,
    head_dim=128,
    activation="swiglu",
    cross_attn_every=5,
    n_media_tokens=1_601,
    d_media=4_096,
    frontend="vision",
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=5, d_model=64, n_heads=4, n_kv_heads=2, d_ff=192,
    vocab=512, head_dim=16, cross_attn_every=5, n_media_tokens=17,
    d_media=64, dtype="f32")


@register_arch("llama-3.2-vision-11b")
def spec() -> ArchSpec:
    return ArchSpec(CONFIG, REDUCED,
                    "hf:meta-llama/Llama-3.2-11B-Vision; unverified")
