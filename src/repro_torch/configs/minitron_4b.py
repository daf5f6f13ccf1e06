"""minitron-4b [dense]: GQA, RoPE, squared-ReLU MLP. [arXiv:2407.14679; hf]

The reference's configuration, copied as the reference has it: a
Minitron model pruned from Nemotron-4 15B (32 layers, d 3072, 24/8
heads of 128, d_ff 9216, vocab 256000). Its MLP is relu(x w1)^2 w2, two
matrices a layer."""

import dataclasses

from repro_torch.configs.base import ArchSpec, ModelConfig, register_arch

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3_072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=9_216,
    vocab=256_000,
    head_dim=128,
    activation="relu2",
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=192,
    vocab=512, head_dim=16, dtype="f32")


@register_arch("minitron-4b")
def spec() -> ArchSpec:
    return ArchSpec(CONFIG, REDUCED, "arXiv:2407.14679; hf")
