"""starcoder2-15b [dense]: GQA, RoPE, GELU MLP. [arXiv:2402.19173; hf]

The reference's configuration, copied as the reference has it: 40
layers, d 6144, 48/4 heads of 128, d_ff 24576, vocab 49152; the MLP is
gelu(x w1) w2 with GELU's tanh approximation (``jax.nn.gelu``'s
default)."""

import dataclasses

from repro_torch.configs.base import ArchSpec, ModelConfig, register_arch

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6_144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24_576,
    vocab=49_152,
    head_dim=128,
    activation="gelu",
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=256,
    vocab=512, head_dim=16, dtype="f32")


@register_arch("starcoder2-15b")
def spec() -> ArchSpec:
    return ArchSpec(CONFIG, REDUCED, "arXiv:2402.19173; hf")
