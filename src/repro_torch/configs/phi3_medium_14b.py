"""phi3-medium-14b [dense]: RoPE SwiGLU GQA. [arXiv:2404.14219]"""

import dataclasses

from repro_torch.configs.base import ArchSpec, ModelConfig, register_arch

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5_120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17_920,
    vocab=100_352,
    head_dim=128,
    activation="swiglu",
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=192,
    vocab=512, head_dim=16, dtype="f32")


@register_arch("phi3-medium-14b")
def spec() -> ArchSpec:
    return ArchSpec(CONFIG, REDUCED, "arXiv:2404.14219; unverified")
